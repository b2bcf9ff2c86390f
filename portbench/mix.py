"""The one generator of traffic: reads a traffic file (traffic/<mix>.json)
and draws its requests from a seed.

A mix is a list of queries.  Each names its reference answer, the SQL
statements of one request ("steps", each with a name and the one whose
rows are fetched), the draws of its substitution parameters, the columns
it must read ("reads": {table: [column]}) and the bytes of a row of its
result.  A query may name a statement that the warm round alone sends
("verify": {"before": step, "sql": .., "reference": ..}): it fetches the
whole answer table that the request made, for the reference to hold
every row of it.  A round sends every query of the mix once, in an order
permuted from the seed; each query draws its parameters anew.

Parameter draws (all inclusive):
  {"int": [lo, hi]}                 an integer
  {"choice": [a, b, ..]}            one of the strings
  {"hundredths": [lo, hi]}          a decimal lo/100 .. hi/100, as "0.06"
  {"year": [lo, hi]}                1 January of a year, as "1994-01-01"
  {"month": ["1993-01", "1997-10"]} the first day of a month
  {"day": ["1995-03-01", "1995-03-31"]} a day
"""

from __future__ import annotations

import datetime
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Request:
    query: str          # the query's name in the mix
    reference: str      # its answer's name in the reference module
    params: tuple       # ((name, value), ..) in the template's order
    steps: tuple        # ((step name, sql, fetch), ..)
    verify: tuple = ()  # (before which step, sql, reference) or ()

    @property
    def key(self):
        """One distinct query text."""
        return (self.query, self.params)


def _draw(rng, spec):
    (kind, arg), = spec.items()
    if kind == "int":
        return int(rng.integers(arg[0], arg[1] + 1))
    if kind == "choice":
        return arg[int(rng.integers(0, len(arg)))]
    if kind == "hundredths":
        return f"{int(rng.integers(arg[0], arg[1] + 1)) / 100:.2f}"
    if kind == "year":
        return f"{int(rng.integers(arg[0], arg[1] + 1))}-01-01"
    if kind == "month":
        y0, m0 = map(int, arg[0].split("-"))
        y1, m1 = map(int, arg[1].split("-"))
        m = int(rng.integers(y0 * 12 + m0 - 1, y1 * 12 + m1))
        return f"{m // 12}-{m % 12 + 1:02d}-01"
    if kind == "day":
        lo = datetime.date.fromisoformat(arg[0])
        n = (datetime.date.fromisoformat(arg[1]) - lo).days
        return (lo + datetime.timedelta(int(rng.integers(0, n + 1)))
                ).isoformat()
    raise ValueError(f"unknown parameter draw {spec!r}")


class Mix:
    def __init__(self, spec: dict):
        self.family = spec["family"]
        self.queries = spec["queries"]
        self.on_failure = tuple(spec.get("on_failure", ()))
        self.by_name = {q["name"]: q for q in self.queries}

    @classmethod
    def load(cls, path: Path) -> "Mix":
        return cls(json.loads(Path(path).read_text()))

    def request(self, q: dict, rng) -> Request:
        params = tuple((name, _draw(rng, d))
                       for name, d in q["params"].items())
        text = dict(params)
        steps = tuple((s["step"], s["sql"].format(**text),
                       bool(s.get("fetch"))) for s in q["steps"])
        v = q.get("verify")
        verify = (v["before"], v["sql"].format(**text), v["reference"]) \
            if v else ()
        return Request(q["name"], q["reference"], params, steps, verify)

    def round(self, rng) -> list:
        """One round: every query once, in an order drawn from rng."""
        return [self.request(self.queries[i], rng)
                for i in rng.permutation(len(self.queries))]

    def read_bytes(self, query: str, rows: dict, kinds: dict, width) -> int:
        """Bytes of the columns a query must read once: rows of each
        table x the resident width of each column it names."""
        return sum(rows[t] * width(kinds[t][c])
                   for t, cols in self.by_name[query]["reads"].items()
                   for c in cols)

    def write_bytes(self, query: str, result_rows: int) -> int:
        return result_rows * self.by_name[query]["result_row_bytes"]


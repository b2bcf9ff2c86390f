"""h2oai db-benchmark's group-by questions q1-q10 in plain torch, as the
checksum row that DuckDB's benchmark computes over each answer
(benchmark/h2oai/group/q*.benchmark: COUNT(DISTINCT key).., SUM(value)..,
COUNT(*) FROM ans), and q1-q5 also as the whole answer table, a row a
group in the order of its keys (q1_groups..).

Groups are dense ids made from the key codes; sums are index_add_,
medians and the top two are read from a stable sort by (group, value),
deviations and correlations are two-pass.  Integer sums are exact in
int64.  float_dtype is the type of every float step: torch.float64 for
the reference, float32 for the control.
"""

from __future__ import annotations

import torch


class State:
    def __init__(self, tables: dict, device, float_dtype, kinds=None):
        self.device = torch.device(device)
        self.fdt = float_dtype
        self.labels = {name: kind[1] for name, kind in
                       (kinds or {}).get("x_group", {}).items()
                       if kind[0] == "dict"}
        self.cols = {name: torch.from_numpy(v).to(self.device)
                     for name, v in tables["x_group"].items()}
        self.n = self.cols["v3"].shape[0]
        self.v3 = self.cols["v3"].to(float_dtype)
        self._groups = {}

    def key(self, name):
        """A key column as int64 codes from 0."""
        c = self.cols[name].long()
        return c if name in ("id1", "id2", "id3") else c - 1

    def groups(self, *names):
        """(dense group id of every row, number of groups); the ids follow
        the order of the keys."""
        return self._grouped(names)[:2]

    def _grouped(self, names):
        if names not in self._groups:
            g = torch.zeros(self.n, dtype=torch.int64, device=self.device)
            bases = []
            for name in names:
                k = self.key(name)
                bases.append(int(k.max()) + 1)
                g = g * bases[-1] + k
            uniq, inv = torch.unique(g, return_inverse=True)
            self._groups[names] = (inv, uniq.shape[0], uniq, bases)
        return self._groups[names]

    def group_keys(self, *names) -> list:
        """The keys of every group as the client gets them: a list for
        each name, in group order."""
        _, _, rest, bases = self._grouped(names)
        out = []
        for name, base in reversed(list(zip(names, bases))):
            code = (rest % base).tolist()
            rest = rest // base
            out.append([self.labels[name][c] for c in code]
                       if name in self.labels else [c + 1 for c in code])
        return out[::-1]

    def distinct(self, name):
        return int(torch.unique(self.key(name)).shape[0])

    def gsum(self, g, ng, values):
        if values.dtype.is_floating_point:
            out = torch.zeros(ng, dtype=self.fdt, device=self.device)
            return out.index_add_(0, g, values.to(self.fdt))
        out = torch.zeros(ng, dtype=torch.int64, device=self.device)
        return out.index_add_(0, g, values.long())

    def count(self, g, ng):
        return torch.bincount(g, minlength=ng)

    def sorted_by_group(self, g, values, descending=False):
        """Row order by (group, value), values ascending or descending."""
        by_v = torch.sort(values, descending=descending, stable=True).indices
        return by_v[torch.sort(g[by_v], stable=True).indices]


def prepare(tables, kinds, device, float_dtype=torch.float64) -> State:
    return State(tables, device, float_dtype, kinds)


def _f(t) -> float:
    return float(t.sum())


def _mean(s, g, ng, values):
    return s.gsum(g, ng, values).to(s.fdt) / s.count(g, ng).to(s.fdt)


def q1(s, p):
    g, ng = s.groups("id1")
    return [(s.distinct("id1"), int(s.cols["v1"].long().sum()), ng)], ng


def q2(s, p):
    g, ng = s.groups("id1", "id2")
    return [(s.distinct("id1"), s.distinct("id2"),
             int(s.cols["v1"].long().sum()), ng)], ng


def q3(s, p):
    g, ng = s.groups("id3")
    return [(s.distinct("id3"), int(s.cols["v1"].long().sum()),
             _f(_mean(s, g, ng, s.v3)), ng)], ng


def q4(s, p):
    g, ng = s.groups("id4")
    c = s.cols
    return [(s.distinct("id4"), _f(_mean(s, g, ng, c["v1"].to(s.fdt))),
             _f(_mean(s, g, ng, c["v2"].to(s.fdt))),
             _f(_mean(s, g, ng, s.v3)), ng)], ng


def q5(s, p):
    g, ng = s.groups("id6")
    c = s.cols
    return [(s.distinct("id6"), int(c["v1"].long().sum()),
             int(c["v2"].long().sum()), _f(s.gsum(g, ng, s.v3)), ng)], ng


def q6(s, p):
    """median (quantile_cont(v3, 0.5)) and stddev_samp(v3) by id4, id5."""
    g, ng = s.groups("id4", "id5")
    order = s.sorted_by_group(g, s.v3)
    vs = s.v3[order]
    cnt = s.count(g, ng)
    start = torch.cumsum(cnt, 0) - cnt
    pos = (cnt - 1).to(s.fdt) * 0.5
    lo = torch.floor(pos)
    frac = pos - lo
    v_lo = vs[start + lo.long()]
    v_hi = vs[start + torch.ceil(pos).long()]
    median = v_lo + (v_hi - v_lo) * frac
    mean = _mean(s, g, ng, s.v3)
    dev = s.gsum(g, ng, (s.v3 - mean[g]) ** 2)
    sd = torch.sqrt(dev / (cnt - 1).to(s.fdt))
    return [(s.distinct("id4"), s.distinct("id5"), _f(median), _f(sd),
             ng)], ng


def q7(s, p):
    """max(v1) - min(v2) by id3."""
    g, ng = s.groups("id3")
    c = s.cols
    hi = torch.full((ng,), -2**62, dtype=torch.int64, device=s.device)
    lo = torch.full((ng,), 2**62, dtype=torch.int64, device=s.device)
    hi.scatter_reduce_(0, g, c["v1"].long(), "amax")
    lo.scatter_reduce_(0, g, c["v2"].long(), "amin")
    return [(s.distinct("id3"), int((hi - lo).sum()), ng)], ng


def q8(s, p):
    """the two largest v3 of every id6."""
    g, ng = s.groups("id6")
    order = s.sorted_by_group(g, s.v3, descending=True)
    gs = g[order]
    cnt = s.count(g, ng)
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(s.n, device=s.device) - start[gs]
    kept = s.v3[order][rank < 2]
    return [(s.distinct("id6"), _f(kept), int(kept.shape[0]))], \
        int(kept.shape[0])


def q9(s, p):
    """pow(corr(v1, v2), 2) by id2, id4."""
    g, ng = s.groups("id2", "id4")
    x, y = s.cols["v1"].to(s.fdt), s.cols["v2"].to(s.fdt)
    dx = x - _mean(s, g, ng, x)[g]
    dy = y - _mean(s, g, ng, y)[g]
    r = s.gsum(g, ng, dx * dy) / torch.sqrt(s.gsum(g, ng, dx * dx)
                                            * s.gsum(g, ng, dy * dy))
    return [(s.distinct("id2"), s.distinct("id4"), _f(r * r), ng)], ng


def q10(s, p):
    """sum(v3), count(*) by all six keys."""
    a, _ = s.groups("id1", "id2", "id3")
    b, nb = s.groups("id4", "id5", "id6")
    ng = int(torch.unique(a * nb + b).shape[0])
    return [(*(s.distinct(f"id{i}") for i in range(1, 7)), _f(s.v3), s.n,
             ng)], ng


def _table(s, names, *values):
    """An answer table: the keys of each group, then its values."""
    rows = list(zip(*s.group_keys(*names), *(v.tolist() for v in values)))
    return rows, len(rows)


def q1_groups(s, p):
    g, ng = s.groups("id1")
    return _table(s, ("id1",), s.gsum(g, ng, s.cols["v1"]))


def q2_groups(s, p):
    g, ng = s.groups("id1", "id2")
    return _table(s, ("id1", "id2"), s.gsum(g, ng, s.cols["v1"]))


def q3_groups(s, p):
    g, ng = s.groups("id3")
    return _table(s, ("id3",), s.gsum(g, ng, s.cols["v1"]),
                  _mean(s, g, ng, s.v3))


def q4_groups(s, p):
    g, ng = s.groups("id4")
    c = s.cols
    return _table(s, ("id4",), *(_mean(s, g, ng, v) for v in (
        c["v1"].to(s.fdt), c["v2"].to(s.fdt), s.v3)))


def q5_groups(s, p):
    g, ng = s.groups("id6")
    c = s.cols
    return _table(s, ("id6",), s.gsum(g, ng, c["v1"]),
                  s.gsum(g, ng, c["v2"]), s.gsum(g, ng, s.v3))


QUERIES = {f"q{i}": f for i, f in enumerate(
    (q1, q2, q3, q4, q5, q6, q7, q8, q9, q10), start=1)}
QUERIES.update({f.__name__: f for f in (q1_groups, q2_groups, q3_groups,
                                        q4_groups, q5_groups)})


def answer(s: State, query: str, params: dict):
    """(the rows the client fetches, rows of the result) of one
    question: its checksum row, or with q<n>_groups its answer table."""
    return QUERIES[query](s, params)

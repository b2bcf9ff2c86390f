"""TPC-H Q1, Q3, Q4 and Q6 in plain torch over the generated columns.

No join, group-by or sort code of the program: joins are boolean and
value tables indexed by key, groups are index_add_ over small dense ids.
Decimals are int64 scaled integers and their sums exact; the answers come
back as the client's rows: Decimal, datetime.date, str, int, float.

float_dtype is the precision of every non-integer step: torch.float64
for the reference, and the control computes the decimal arithmetic and
the averages in float32 instead.
"""

from __future__ import annotations

import datetime
from decimal import Decimal

import torch

_EPOCH = datetime.date(1970, 1, 1)
Q1_BASE = "1998-12-01"


def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - _EPOCH).days


def date_of(n: int) -> datetime.date:
    return _EPOCH + datetime.timedelta(days=int(n))


def add_months(iso: str, months: int) -> str:
    d = datetime.date.fromisoformat(iso)
    m = d.month - 1 + months
    return d.replace(year=d.year + m // 12, month=m % 12 + 1).isoformat()


class _OnDevice(dict):
    """Columns copied to the device when first used."""

    def __init__(self, arrays: dict, device):
        super().__init__()
        self.arrays, self.device = arrays, device

    def __missing__(self, name):
        t = self[name] = torch.from_numpy(self.arrays[name]).to(self.device)
        return t


class State:
    """The generated columns, on the device as they are used, with the
    labels of each dictionary column."""

    def __init__(self, tables: dict, kinds: dict, device, float_dtype):
        self.device = torch.device(device)
        self.fdt = float_dtype
        self.labels = {name: kind[1] for table in tables
                       for name, kind in kinds[table].items()
                       if kind[0] == "dict"}
        self.cols = _OnDevice({name: values for table, cols in
                               tables.items() for name, values in
                               cols.items()
                               if kinds[table][name][0] != "text"},
                              self.device)
        self._late = None
        self._q1 = None
        self._by_key = {}

    @property
    def exact(self) -> bool:
        return self.fdt == torch.float64

    @property
    def sum_dtype(self):
        """Decimal sums: exact in int64 for the reference, in the float
        type for the control."""
        return torch.int64 if self.exact else self.fdt

    def sums(self, values, index, size):
        """Sums of an integer column by group."""
        out = torch.zeros(size, dtype=self.sum_dtype, device=self.device)
        return out.index_add_(0, index, values.to(self.sum_dtype))

    def integer(self, total) -> int:
        """A sum of integers as the client gets it (the control's
        rounded)."""
        return int(total) if self.exact else int(round(float(total)))

    def avg(self, total, count: int, scale: int) -> float:
        """avg() of a decimal column: its sum over the count, in the float
        type."""
        t = torch.as_tensor(total, dtype=self.fdt)
        return float(t / 10**scale / count)

    def q1_table(self):
        """Q1's sums by (returnflag, linestatus) and shipdate day: a
        query's cutoff takes a prefix of the days."""
        if self._q1 is None:
            c = self.cols
            ship = c["l_shipdate"].long()
            day0 = int(ship.min())
            ndays = int(ship.max()) - day0 + 1
            key = (c["l_returnflag"] * 2 + c["l_linestatus"]).long() \
                * ndays + (ship - day0)
            ext, disc = c["l_extendedprice"], c["l_discount"]
            disc_price = ext * (100 - disc)
            values = (c["l_quantity"], ext, disc_price,
                      disc_price * (100 + c["l_tax"]), disc)
            self._q1 = (day0,
                        torch.bincount(key, minlength=6 * ndays)
                        .view(6, ndays),
                        [self.sums(v, key, 6 * ndays).view(6, ndays)
                         for v in values])
        return self._q1

    def by_orderkey(self, name):
        """An orders column as a table indexed by o_orderkey."""
        if name not in self._by_key:
            c = self.cols
            t = torch.zeros(int(c["o_orderkey"].max()) + 1,
                            dtype=c[name].dtype, device=self.device)
            t[c["o_orderkey"].long()] = c[name]
            self._by_key[name] = t
        return self._by_key[name]

    def late_orders(self):
        """A boolean by order key: the order has a line committed before
        it was received (Q4's EXISTS)."""
        if self._late is None:
            c = self.cols
            late = torch.zeros(int(c["o_orderkey"].max()) + 1,
                               dtype=torch.bool, device=self.device)
            late[c["l_orderkey"][c["l_commitdate"] < c["l_receiptdate"]]
                 .long()] = True
            self._late = late
        return self._late


def prepare(tables, kinds, device, float_dtype=torch.float64) -> State:
    return State(tables, kinds, device, float_dtype)


def dec(v: int, scale: int) -> Decimal:
    return Decimal(v).scaleb(-scale)


def q1(s: State, p: dict):
    day0, counts, sums = s.q1_table()
    upto = max(days(Q1_BASE) - int(p["delta"]) - day0 + 1, 0)
    count = counts[:, :upto].sum(1).tolist()
    qty, ext, disc_price, charge, disc = (t[:, :upto].sum(1) for t in sums)
    rows = []
    for k in range(6):
        n = count[k]
        if not n:
            continue
        rows.append((s.labels["l_returnflag"][k // 2],
                     s.labels["l_linestatus"][k % 2],
                     dec(s.integer(qty[k]), 2), dec(s.integer(ext[k]), 2),
                     dec(s.integer(disc_price[k]), 4),
                     dec(s.integer(charge[k]), 6),
                     s.avg(qty[k], n, 2), s.avg(ext[k], n, 2),
                     s.avg(disc[k], n, 2), n))
    return rows, len(rows)


def q6(s: State, p: dict):
    c = s.cols
    year = int(p["date"][:4])
    d = int(Decimal(p["discount"]) * 100)
    ship, disc = c["l_shipdate"], c["l_discount"]
    keep = ((ship >= days(f"{year}-01-01"))
            & (ship < days(f"{year + 1}-01-01"))
            & (disc >= d - 1) & (disc <= d + 1)
            & (c["l_quantity"] < int(p["quantity"]) * 100))
    if not bool(keep.any()):
        return [(None,)], 1
    rev = (c["l_extendedprice"] * disc).to(s.sum_dtype)
    return [(dec(s.integer(torch.where(keep, rev, 0).sum()), 4),)], 1


def q3(s: State, p: dict):
    c = s.cols
    date = days(p["date"])
    seg = s.labels["c_mktsegment"].index(p["segment"])
    nkeys = int(c["o_orderkey"].max()) + 1
    cust_ok = torch.zeros(int(c["c_custkey"].max()) + 1, dtype=torch.bool,
                          device=s.device)
    cust_ok[c["c_custkey"].long()] = c["c_mktsegment"] == seg
    o_ok = cust_ok[c["o_custkey"].long()] & (c["o_orderdate"] < date)
    order_ok = torch.zeros(nkeys, dtype=torch.bool, device=s.device)
    order_ok[c["o_orderkey"][o_ok].long()] = True
    lkey = c["l_orderkey"].long()
    l_ok = order_ok[lkey] & (c["l_shipdate"] > date)
    keys = torch.unique(lkey[l_ok])
    # each qualifying order's revenue, by its rank among the keys
    slot = torch.searchsorted(keys, lkey[l_ok])
    rev_line = (c["l_extendedprice"][l_ok] * (100 - c["l_discount"][l_ok]))
    revenue = s.sums(rev_line, slot, keys.shape[0])
    odate = s.by_orderkey("o_orderdate")
    oship = s.by_orderkey("o_shippriority")
    dates = odate[keys]
    # ORDER BY revenue DESC, o_orderdate; LIMIT 10
    by_date = torch.sort(dates, stable=True).indices
    by_rev = torch.sort(revenue[by_date], descending=True, stable=True).indices
    top = by_date[by_rev][:10]
    rows = [(k, dec(s.integer(r), 4), date_of(d), sp) for k, r, d, sp in
            zip(keys[top].tolist(), revenue[top].tolist(),
                dates[top].tolist(), oship[keys[top]].tolist())]
    return rows, len(rows)


def q4(s: State, p: dict):
    c = s.cols
    lo, hi = days(p["date"]), days(add_months(p["date"], 3))
    od = c["o_orderdate"]
    keep = (od >= lo) & (od < hi) & s.late_orders()[c["o_orderkey"].long()]
    counts = torch.bincount(c["o_orderpriority"][keep].long(),
                            minlength=len(s.labels["o_orderpriority"]))
    rows = [(s.labels["o_orderpriority"][i], n)
            for i, n in enumerate(counts.tolist()) if n]
    return rows, len(rows)


QUERIES = {"q1": q1, "q3": q3, "q4": q4, "q6": q6}


def answer(s: State, query: str, params: dict):
    """(rows, result rows) of one query text: the rows the client
    fetches, and the rows of the result the query makes."""
    return QUERIES[query](s, params)

"""TPC-H's eight tables with every column, drawn from a seed by the rules of
the TPC-H specification, clause 4.2.3, at the sizes of clause 4.2.5.

- o_orderkey is sparse: the first 8 of every 32 values.
- o_custkey is never a multiple of 3; o_orderdate is uniform in
  [1992-01-01, 1998-08-02] (ENDDATE less 151 days); o_orderstatus is F
  where every line is F, O where every line is O, else P; o_totalprice is
  the sum of its lines' extendedprice x (1 - discount) x (1 + tax), each
  product truncated to cents as dbgen does.
- Each order has 1 to 7 lines, numbered from 1.  l_partkey is uniform over
  the parts, l_suppkey one of its part's four suppliers.  l_shipdate =
  o_orderdate + [1, 121], l_commitdate = o_orderdate + [30, 90],
  l_receiptdate = l_shipdate + [1, 30] days.
- l_quantity in [1, 50], l_discount in [0.00, 0.10], l_tax in
  [0.00, 0.08]; l_extendedprice = l_quantity x p_retailprice of the part.
- l_returnflag is R or A at random where l_receiptdate <= CURRENTDATE
  (1995-06-17), else N; l_linestatus is O where l_shipdate > CURRENTDATE,
  else F.
- p_retailprice = (90000 + ((partkey / 10) mod 20001) + 100 x (partkey
  mod 1000)) cents; partsupp has four suppliers a part, by the spec's
  formula.
- Names, phones and addresses are unique strings by the spec's formats;
  comments are random substrings, of the spec's lengths, of a text pool
  made from the spec's grammar words (of config["text_pool_bytes"]).

Small enumerations (segments, priorities, flags, instructions, modes) are
int32 codes into the label tuples below, kind ("dict", labels); every
other string column is a pyarrow DictionaryArray made here, kind
("text",).  Decimals are int64 scaled by 100, dates int32 days since
1970-01-01.  Lineitem rows follow their orders.  The key shapes follow
ddb_tpu_torch/bench/tpch.py's synth_join_tables, copied here so that the
benchmark does not move with the program.
"""

from __future__ import annotations

import datetime

import numpy as np
import pyarrow as pa

from ..columns import seed_rng

MKTSEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
               "MACHINERY")
ORDERPRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                   "5-LOW")
ORDERSTATUSES = ("F", "O", "P")
RETURNFLAGS = ("A", "N", "R")
LINESTATUSES = ("F", "O")
SHIPINSTRUCTS = ("COLLECT COD", "DELIVER IN PERSON", "NONE",
                 "TAKE BACK RETURN")
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
NATIONS = (("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
COLORS = tuple("""almond antique aquamarine azure beige bisque black blanched
blue blush brown burlywood burnished chartreuse chiffon chocolate coral
cornflower cornsilk cream cyan dark deep dim dodger drab firebrick floral
forest frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory
khaki lace lavender lawn lemon light lime linen magenta maroon medium
metallic midnight mint misty moccasin navajo navy olive orange orchid pale
papaya peach peru pink plum powder puff purple red rose rosy royal saddle
salmon sandy seashell sienna sky slate smoke snow spring steel tan thistle
tomato turquoise violet wheat white yellow""".split())
TYPES = (("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
         ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
         ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINERS = (("SM", "LG", "MED", "JUMBO", "WRAP"),
              ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))
# the grammar's words (clause 4.2.2.13), from which the text pool is made
WORDS = tuple("""foxes ideas theodolites pinto beans instructions dependencies
excuses platelets asymptotes courts dolphins multipliers sauternes warthogs
frets dinos attainments somas Tiresias' patterns forges braids hockey players
frays warhorses dugouts notornis epitaphs pearls tithes waters orbits gifts
sheaves depths sentiments decoys realms pains grouches escapades requests
packages accounts deposits sleep wake are cajole haggle nag use boost affix
detect integrate maintain nod was lose sublate solve thrash promise engage
hinder print x-ray breach eat grow impress mold poach serve run dazzle snooze
doze unwind kindle play hang believe doubt furious sly careful blithe quick
fluffy slow quiet ruthless thin close dogged daring brave stealthy permanent
enticing idle busy regular final ironic even bold silent special pending
express unusual sometimes always never furiously slyly carefully blithely
quickly fluffily slowly quietly ruthlessly thinly closely doggedly daringly
bravely stealthily permanently enticingly idly busily regularly finally
ironically evenly boldly silently about above according to across after
against along among around at atop before behind beneath beside besides
between beyond by despite during except for from inside instead of into near
of on outside over past since through throughout to toward under until up
upon without with within the. the; the: the? the! the--""".split())
ALNUM = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyz "
                      b"ABCDEFGHIJKLMNOPQRSTUVWXYZ,", dtype=np.uint8)
DEC = ("decimal", 15, 2)
I32, DATE, TEXT = ("int32",), ("date",), ("text",)
KINDS = {
    "region": {"r_regionkey": I32, "r_name": TEXT, "r_comment": TEXT},
    "nation": {"n_nationkey": I32, "n_name": TEXT, "n_regionkey": I32,
               "n_comment": TEXT},
    "part": {"p_partkey": I32, "p_name": TEXT, "p_mfgr": TEXT,
             "p_brand": TEXT, "p_type": TEXT, "p_size": I32,
             "p_container": TEXT, "p_retailprice": DEC, "p_comment": TEXT},
    "supplier": {"s_suppkey": I32, "s_name": TEXT, "s_address": TEXT,
                 "s_nationkey": I32, "s_phone": TEXT, "s_acctbal": DEC,
                 "s_comment": TEXT},
    "partsupp": {"ps_partkey": I32, "ps_suppkey": I32, "ps_availqty": I32,
                 "ps_supplycost": DEC, "ps_comment": TEXT},
    "customer": {"c_custkey": I32, "c_name": TEXT, "c_address": TEXT,
                 "c_nationkey": I32, "c_phone": TEXT, "c_acctbal": DEC,
                 "c_mktsegment": ("dict", MKTSEGMENTS), "c_comment": TEXT},
    "orders": {"o_orderkey": I32, "o_custkey": I32,
               "o_orderstatus": ("dict", ORDERSTATUSES),
               "o_totalprice": DEC, "o_orderdate": DATE,
               "o_orderpriority": ("dict", ORDERPRIORITIES),
               "o_clerk": TEXT, "o_shippriority": I32, "o_comment": TEXT},
    "lineitem": {"l_orderkey": I32, "l_partkey": I32, "l_suppkey": I32,
                 "l_linenumber": I32, "l_quantity": DEC,
                 "l_extendedprice": DEC, "l_discount": DEC, "l_tax": DEC,
                 "l_returnflag": ("dict", RETURNFLAGS),
                 "l_linestatus": ("dict", LINESTATUSES),
                 "l_shipdate": DATE, "l_commitdate": DATE,
                 "l_receiptdate": DATE,
                 "l_shipinstruct": ("dict", SHIPINSTRUCTS),
                 "l_shipmode": ("dict", SHIPMODES), "l_comment": TEXT},
}
# (shortest, longest) characters of each comment (clause 4.2.3)
COMMENT_LENGTHS = {"r_comment": (31, 115), "n_comment": (31, 114),
                   "p_comment": (5, 22), "s_comment": (25, 100),
                   "ps_comment": (49, 198), "c_comment": (29, 116),
                   "o_comment": (19, 78), "l_comment": (10, 43)}

_EPOCH = datetime.date(1970, 1, 1)


def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - _EPOCH).days


CURRENTDATE = days("1995-06-17")


def kinds(config: dict) -> dict:
    return KINDS


def sizes(config: dict) -> dict:
    """Rows of each table at config's scale factor (clause 4.2.5)."""
    sf = config["scale_factor"]
    part = int(sf * 200_000)
    return {"part": part, "supplier": int(sf * 10_000),
            "partsupp": 4 * part, "customer": int(sf * 150_000),
            "orders": int(sf * 1_500_000)}


# -- strings ---------------------------------------------------------------

def strings(data: np.ndarray, lengths: np.ndarray) -> pa.Array:
    """An Arrow string array of the rows of a uint8 matrix, each cut to its
    length."""
    keep = np.arange(data.shape[1]) < lengths[:, None]
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return pa.Array.from_buffers(
        pa.large_string(), len(lengths),
        [None, pa.py_buffer(offsets), pa.py_buffer(data[keep])]
    ).cast(pa.string())


def labelled(labels: tuple, codes: np.ndarray) -> pa.DictionaryArray:
    return pa.DictionaryArray.from_arrays(
        pa.array(np.ascontiguousarray(codes, dtype=np.int32)),
        pa.array(list(labels), type=pa.string()))


def unique(values: pa.Array) -> pa.DictionaryArray:
    """A column of distinct strings as a dictionary array."""
    return pa.DictionaryArray.from_arrays(
        pa.array(np.arange(len(values), dtype=np.int32)), values)


def numbered(prefix: str, keys: np.ndarray, digits: int = 9) -> pa.Array:
    """'Customer#000000001'.. : a prefix and a zero-padded number, as
    strings."""
    head = np.frombuffer(prefix.encode(), dtype=np.uint8)
    k = keys.astype(np.int64)
    data = np.empty((len(k), len(head) + digits), dtype=np.uint8)
    data[:, :len(head)] = head
    for i in range(digits):
        data[:, len(head) + i] = k // 10 ** (digits - 1 - i) % 10 + 48
    return strings(data, np.full(len(k), data.shape[1]))


def v_string(rng, n: int, lo: int = 10, hi: int = 40) -> pa.DictionaryArray:
    """Addresses: random alphanumeric strings of lo..hi characters."""
    data = ALNUM[rng.integers(0, len(ALNUM), (n, hi))]
    return unique(strings(data, rng.integers(lo, hi + 1, n)))


def phones(rng, nationkey: np.ndarray) -> pa.DictionaryArray:
    """'CC-NNN-NNN-NNNN', CC the nation's key plus 10."""
    n = len(nationkey)
    parts = [(nationkey + 10, 2), (rng.integers(100, 1000, n), 3),
             (rng.integers(100, 1000, n), 3), (rng.integers(1000, 10000, n),
                                               4)]
    data = np.full((n, 15), ord("-"), dtype=np.uint8)
    col = 0
    for values, digits in parts:
        for i in range(digits):
            data[:, col + i] = values // 10 ** (digits - 1 - i) % 10 + 48
        col += digits + 1
    return unique(strings(data, np.full(n, 15)))


def color_names(names: np.ndarray) -> pa.Array:
    """p_name: the colours of each row of `names` (n x 5 indices into
    COLORS), separated by spaces."""
    width = max(map(len, COLORS)) + 1
    word = np.zeros((len(COLORS), width), dtype=np.uint8)
    for i, c in enumerate(COLORS):
        word[i, :len(c) + 1] = np.frombuffer(c.encode() + b" ", np.uint8)
    wlen = np.array([len(c) + 1 for c in COLORS])[names]
    data = np.zeros((len(names), 5 * width), dtype=np.uint8)
    rows = np.arange(len(names))[:, None]
    at = np.zeros(len(names), dtype=np.int64)
    for k in range(5):
        cols = at[:, None] + np.arange(width)
        keep = np.arange(width) < wlen[:, k, None]
        data[np.broadcast_to(rows, cols.shape)[keep], cols[keep]] = \
            word[names[:, k]][keep]
        at += wlen[:, k]
    return strings(data, at - 1)


def clerks(rng, n: int, scale_factor) -> pa.DictionaryArray:
    """o_clerk: 'Clerk#000000001'.. of SF x 1000 clerks."""
    count = max(int(scale_factor * 1000), 1)
    return pa.DictionaryArray.from_arrays(
        pa.array(rng.integers(0, count, n, dtype=np.int32)),
        numbered("Clerk#", np.arange(1, count + 1)))


def text_pool(rng, size: int) -> np.ndarray:
    """`size` bytes of the grammar's words, separated by spaces."""
    words = [w.encode() for w in WORDS]
    mean = sum(map(len, words)) / len(words) + 1
    out = b" ".join(words[i] for i in rng.integers(
        0, len(words), int(size / mean * 1.2) + 16))
    while len(out) < size:
        out += b" " + out
    return np.frombuffer(out[:size], dtype=np.uint8)


def comments(rng, pool: np.ndarray, n: int, lo: int, hi: int,
             chunk: int = 1 << 16) -> pa.DictionaryArray:
    """Random substrings of the pool of lo..hi characters, as dbgen makes
    them: a length and an offset drawn for each row.  The dictionary holds
    the substrings that were drawn, each once."""
    size = len(pool)
    ring = np.concatenate([pool, pool[:hi]])
    code = rng.integers(0, hi - lo + 1, n) * size + rng.integers(0, size, n)
    seen = np.zeros((hi - lo + 1) * size, dtype=bool)
    seen[code] = True
    used = np.flatnonzero(seen)
    rank = np.cumsum(seen, dtype=np.int64) - 1
    lengths = used // size + lo
    starts = used % size
    parts = []
    for i in range(0, len(used), chunk):
        at = starts[i:i + chunk, None] + np.arange(hi)
        parts.append(strings(ring[at], lengths[i:i + chunk]))
    values = pa.concat_arrays(parts) if parts else pa.array([], pa.string())
    return pa.DictionaryArray.from_arrays(
        pa.array(rank[code].astype(np.int32)), values)


# -- tables ----------------------------------------------------------------

def supplier_of(partkey: np.ndarray, i, suppliers: int) -> np.ndarray:
    """The i-th (0..3) supplier of a part (clause 4.2.3, PS_SUPPKEY)."""
    p = partkey.astype(np.int64)
    return ((p + i * (suppliers // 4 + (p - 1) // suppliers)) % suppliers
            + 1).astype(np.int32)


def retail_price(partkey: np.ndarray) -> np.ndarray:
    """p_retailprice in cents."""
    p = partkey.astype(np.int64)
    return 90000 + (p // 10) % 20001 + 100 * (p % 1000)


def generate(config: dict, seed: int) -> dict:
    """{table: {column: numpy array or pyarrow DictionaryArray}} at
    config's "scale_factor"."""
    rng = seed_rng(seed)
    n = sizes(config)
    i32 = np.int32
    pool = text_pool(rng, config["text_pool_bytes"])

    def text(name, rows):
        return comments(rng, pool, rows, *COMMENT_LENGTHS[name])

    def acctbal(rows):
        return rng.integers(-99999, 1000000, rows)

    region = {"r_regionkey": np.arange(5, dtype=i32),
              "r_name": unique(pa.array(list(REGIONS))),
              "r_comment": text("r_comment", 5)}
    nation = {"n_nationkey": np.arange(25, dtype=i32),
              "n_name": unique(pa.array([nm for nm, _ in NATIONS])),
              "n_regionkey": np.array([r for _, r in NATIONS], dtype=i32),
              "n_comment": text("n_comment", 25)}

    n_part, n_supp = n["part"], n["supplier"]
    partkey = np.arange(1, n_part + 1, dtype=i32)
    names = rng.integers(0, len(COLORS), (n_part, 5))
    while True:     # five distinct words a name
        s = np.sort(names, axis=1)
        dup = np.flatnonzero((s[:, 1:] == s[:, :-1]).any(axis=1))
        if not len(dup):
            break
        names[dup] = rng.integers(0, len(COLORS), (len(dup), 5))
    p_name = pa.concat_arrays([color_names(names[i:i + (1 << 18)])
                               for i in range(0, n_part, 1 << 18)])
    mfgr = rng.integers(0, 5, n_part)
    brand = mfgr * 5 + rng.integers(0, 5, n_part)
    ptype = [rng.integers(0, len(t), n_part) for t in TYPES]
    type_labels = [f"{a} {b} {c}" for a in TYPES[0] for b in TYPES[1]
                   for c in TYPES[2]]
    cont = [rng.integers(0, len(t), n_part) for t in CONTAINERS]
    cont_labels = [f"{a} {b}" for a in CONTAINERS[0] for b in CONTAINERS[1]]
    part = {
        "p_partkey": partkey,
        "p_name": unique(p_name),
        "p_mfgr": labelled(tuple(f"Manufacturer#{m}" for m in range(1, 6)),
                           mfgr),
        "p_brand": labelled(tuple(f"Brand#{m}{b}" for m in range(1, 6)
                                  for b in range(1, 6)), brand),
        "p_type": labelled(tuple(type_labels),
                           (ptype[0] * 5 + ptype[1]) * 5 + ptype[2]),
        "p_size": rng.integers(1, 51, n_part, dtype=i32),
        "p_container": labelled(tuple(cont_labels), cont[0] * 8 + cont[1]),
        "p_retailprice": retail_price(partkey),
        "p_comment": text("p_comment", n_part),
    }
    s_nation = rng.integers(0, 25, n_supp, dtype=i32)
    supplier = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=i32),
        "s_name": unique(numbered("Supplier#", np.arange(1, n_supp + 1))),
        "s_address": v_string(rng, n_supp),
        "s_nationkey": s_nation,
        "s_phone": phones(rng, s_nation),
        "s_acctbal": acctbal(n_supp),
        "s_comment": text("s_comment", n_supp),
    }
    ps_part = np.repeat(partkey, 4)
    partsupp = {
        "ps_partkey": ps_part,
        "ps_suppkey": supplier_of(ps_part, np.tile(np.arange(4), n_part),
                                  n_supp),
        "ps_availqty": rng.integers(1, 10000, 4 * n_part, dtype=i32),
        "ps_supplycost": rng.integers(100, 100001, 4 * n_part),
        "ps_comment": text("ps_comment", 4 * n_part),
    }
    del ps_part

    n_cust, n_orders = n["customer"], n["orders"]
    c_nation = rng.integers(0, 25, n_cust, dtype=i32)
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=i32),
        "c_name": unique(numbered("Customer#", np.arange(1, n_cust + 1))),
        "c_address": v_string(rng, n_cust),
        "c_nationkey": c_nation,
        "c_phone": phones(rng, c_nation),
        "c_acctbal": acctbal(n_cust),
        "c_mktsegment": rng.integers(0, len(MKTSEGMENTS), n_cust, dtype=i32),
        "c_comment": text("c_comment", n_cust),
    }
    i = np.arange(n_orders, dtype=np.int64)
    # two thirds of the customer keys are not multiples of 3: draw an
    # index among those and map it to its key
    j = rng.integers(0, n_cust - n_cust // 3, n_orders)
    o_orderdate = rng.integers(days("1992-01-01"), days("1998-08-02") + 1,
                               n_orders, dtype=i32)
    orderkey = ((i // 8) * 32 + i % 8 + 1).astype(i32)
    del i
    lines = rng.integers(1, 8, n_orders)
    first = np.zeros(n_orders, dtype=np.int64)
    np.cumsum(lines[:-1], out=first[1:])
    nl = int(lines.sum())
    odate = np.repeat(o_orderdate, lines)
    shipdate = odate + rng.integers(1, 122, nl, dtype=i32)
    commitdate = odate + rng.integers(30, 91, nl, dtype=i32)
    del odate
    receiptdate = shipdate + rng.integers(1, 31, nl, dtype=i32)
    l_partkey = rng.integers(1, n_part + 1, nl, dtype=i32)
    quantity = rng.integers(1, 51, nl).astype(np.int64)
    extended = quantity * retail_price(l_partkey)
    discount = rng.integers(0, 11, nl).astype(np.int64)
    tax = rng.integers(0, 9, nl).astype(np.int64)
    returned = rng.integers(0, 2, nl, dtype=i32) * 2       # A (0) or R (2)
    linestatus = (shipdate > CURRENTDATE).astype(i32)
    open_lines = np.add.reduceat(linestatus, first)
    charge = extended * (100 - discount) // 100 * (100 + tax) // 100
    lineitem = {
        "l_orderkey": np.repeat(orderkey, lines),
        "l_partkey": l_partkey,
        "l_suppkey": supplier_of(l_partkey, rng.integers(0, 4, nl), n_supp),
        "l_linenumber": (np.arange(nl) - np.repeat(first, lines) + 1)
        .astype(i32),
        "l_quantity": quantity * 100,
        "l_extendedprice": extended,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": np.where(receiptdate <= CURRENTDATE, returned,
                                 i32(1)).astype(i32),
        "l_linestatus": linestatus,
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
        "l_shipinstruct": rng.integers(0, len(SHIPINSTRUCTS), nl, dtype=i32),
        "l_shipmode": rng.integers(0, len(SHIPMODES), nl, dtype=i32),
        "l_comment": text("l_comment", nl),
    }
    orders = {
        "o_orderkey": orderkey,
        "o_custkey": (j // 2 * 3 + j % 2 + 1).astype(i32),
        "o_orderstatus": np.where(open_lines == 0, 0,
                                  np.where(open_lines == lines, 1, 2))
        .astype(i32),
        "o_totalprice": np.add.reduceat(charge, first),
        "o_orderdate": o_orderdate,
        "o_orderpriority": rng.integers(0, len(ORDERPRIORITIES), n_orders,
                                        dtype=i32),
        "o_clerk": clerks(rng, n_orders, config["scale_factor"]),
        "o_shippriority": np.zeros(n_orders, dtype=i32),
        "o_comment": text("o_comment", n_orders),
    }
    return {"region": region, "nation": nation, "part": part,
            "supplier": supplier, "partsupp": partsupp,
            "customer": customer, "orders": orders, "lineitem": lineitem}

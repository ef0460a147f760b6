"""The benchmark's own TPC-H lineitem generator, by TPC-H v3.0.1 clause
4.2.3 (ORDERS and LINEITEM; the dates of 4.2.2.12, the text of
4.2.2.10 and 4.2.2.14).

Orders are generated in slices of ``orders_per_slice`` orders; a slice's
rows are the lines of its orders, 1 to 7 an order, in order.  Each slice
and each of its draws has a stream of its own, ``np.random.default_rng(
[seed, slice, stream])``, so a slice, and any subset of its columns, is
the same whichever others are made.  Per order: ``O_ORDERDATE`` uniform
in [STARTDATE, ENDDATE - 151], the number of lines in [1, 7], the order
key sparse (the first 8 keys of every 32).  Per line:

- ``L_PARTKEY`` in [1, SF * 200,000]; ``L_SUPPKEY`` one of the part's 4
  suppliers, ``(p + i * (S / 4 + (p - 1) / S)) % S + 1``, i in [0, 3];
- ``L_QUANTITY`` in [1, 50]; ``L_EXTENDEDPRICE`` = quantity *
  ``P_RETAILPRICE`` of the part, ``(90000 + (p / 10) % 20001 + 100 *
  (p % 1000)) / 100``;
- ``L_DISCOUNT`` in [0.00, 0.10], ``L_TAX`` in [0.00, 0.08];
- ``L_SHIPDATE`` = order date + [1, 121], ``L_COMMITDATE`` = order date
  + [30, 90], ``L_RECEIPTDATE`` = ship date + [1, 30];
- ``L_RETURNFLAG`` "R" or "A" at random where the receipt date is on or
  before CURRENTDATE, else "N"; ``L_LINESTATUS`` "O" where the ship date
  is after CURRENTDATE, else "F";
- ``L_SHIPINSTRUCT`` and ``L_SHIPMODE`` from their lists; ``L_COMMENT`` a
  text string of [10, 43] bytes of the text pool (``text.py``).

Money is int64 hundredths and quantity int64 units; dates are int32 days
since 1992-01-01 (STARTDATE); keys int64, the line number int32.
String columns are held as int8 codes into their lists, the comment as
(offsets, bytes).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from . import text

STARTDATE = 0  # 1992-01-01
CURRENTDATE = 1263  # 1995-06-17
ENDDATE = 2556  # 1998-12-31
ORDERDATE_LAST = ENDDATE - 151
DAYS_TO_1992 = 8035  # 1970-01-01 .. 1992-01-01: a date32's value is this + the day
ORDERS_PER_SF, PARTS_PER_SF, SUPPLIERS_PER_SF = 1_500_000, 200_000, 10_000
COMMENT_BYTES = (10, 43)

RETURNFLAGS = np.array(["A", "N", "R"])
LINESTATUSES = np.array(["F", "O"])
SHIPINSTRUCTS = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"])
SHIPMODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"])
CODED = {"l_returnflag": RETURNFLAGS, "l_linestatus": LINESTATUSES,
         "l_shipinstruct": SHIPINSTRUCTS, "l_shipmode": SHIPMODES}
TEXT = ("l_comment",)

COLUMNS = (
    "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity", "l_extendedprice",
    "l_discount", "l_tax", "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
    "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment",
)
# the draws' streams, by number: a column is made from its own and those
# it derives from
_STREAM = {"orders": 0, "lines": 1, "partkey": 2, "supplier": 3, "quantity": 4,
           "discount": 5, "tax": 6, "ship": 7, "commit": 8, "receipt": 9, "flag": 10,
           "shipinstruct": 11, "shipmode": 12, "comment": 13}
_TEXT_POOL_SEED = (19920101, 4, 2, 14)  # the pool is one text, as dbgen's is


class Lineitem:
    """Generated lineitem rows: integer columns as numpy arrays, string
    columns as int8 codes into ``CODED``, the comment as (int64 offsets,
    uint8 bytes).  :meth:`column` gives a coded column as numpy unicode."""

    def __init__(self, rows: int, ints: Dict[str, np.ndarray], codes: Dict[str, np.ndarray],
                 texts: Dict[str, Tuple[np.ndarray, np.ndarray]]):
        self.rows = rows
        self.ints = ints
        self.codes = codes
        self.texts = texts

    @property
    def names(self):
        return [c for c in COLUMNS if c in self.ints or c in self.codes or c in self.texts]

    def column(self, name: str) -> np.ndarray:
        if name in self.codes:
            return CODED[name][self.codes[name]]
        if name in self.texts:
            raise TypeError(f"{name} is text: take it from .texts")
        return self.ints[name]

    def columns(self, names: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        return {n: self.column(n) for n in (names or self.names)}

    def strings(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """A string column as (int64 offsets of rows + 1, uint8 bytes)."""
        if name in self.texts:
            return self.texts[name]
        words = CODED[name]
        lens = np.array([len(w) for w in words], dtype=np.int64)
        flat = np.frombuffer("".join(words).encode(), np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        c = self.codes[name]
        offsets = np.zeros(len(c) + 1, dtype=np.int64)
        np.cumsum(lens[c], out=offsets[1:])
        return offsets, flat[text._ranges(starts[c], lens[c])]


def _need(columns: Sequence[str]) -> set:
    unknown = set(columns) - set(COLUMNS)
    if unknown:
        raise ValueError(f"unknown lineitem columns {sorted(unknown)}")
    need = set(columns)
    if need & {"l_extendedprice", "l_suppkey"}:
        need.add("l_partkey")
    if "l_extendedprice" in need:
        need.add("l_quantity")
    if need & {"l_returnflag", "l_receiptdate", "l_linestatus"}:
        need.update(("l_shipdate", "l_receiptdate"))
    return need


def order_keys(first: int, n: int) -> np.ndarray:
    """Sparse order keys of orders ``first`` .. ``first + n - 1`` (0 on):
    of every 32 keys the first 8 are used (dbgen's ``mk_sparse``)."""
    i = np.arange(first + 1, first + n + 1, dtype=np.int64)
    return ((i >> 3) << 5) + (i & 7)


def generate_slice(seed: int, scale: float, index: int, orders: int,
                   columns: Sequence[str] = COLUMNS, pool: Optional[np.ndarray] = None) -> Lineitem:
    """The rows of orders ``index * orders`` .. ``(index + 1) * orders -
    1`` of lineitem at scale factor ``scale``; only ``columns`` and what
    they derive from are made.  ``pool`` is the text pool (``text_pool``)
    where ``l_comment`` is asked for."""
    need = _need(columns)

    def rng(stream):
        return np.random.default_rng([int(seed), int(index), _STREAM[stream]])

    orderdate = rng("orders").integers(STARTDATE, ORDERDATE_LAST + 1, orders).astype(np.int32)
    nlines = rng("lines").integers(1, 8, orders)
    n = int(nlines.sum())
    ints: Dict[str, np.ndarray] = {}
    codes: Dict[str, np.ndarray] = {}
    texts: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    if "l_orderkey" in need:
        ints["l_orderkey"] = np.repeat(order_keys(index * orders, orders), nlines)
    if "l_linenumber" in need:
        starts = np.cumsum(nlines) - nlines
        ints["l_linenumber"] = (np.arange(n) - np.repeat(starts, nlines) + 1).astype(np.int32)
    if "l_partkey" in need:
        ints["l_partkey"] = rng("partkey").integers(1, int(scale * PARTS_PER_SF) + 1, n)
    if "l_suppkey" in need:
        s = int(scale * SUPPLIERS_PER_SF)
        p = ints["l_partkey"]
        i = rng("supplier").integers(0, 4, n)
        ints["l_suppkey"] = (p + i * (s // 4 + (p - 1) // s)) % s + 1
    if "l_quantity" in need:
        ints["l_quantity"] = rng("quantity").integers(1, 51, n)
    if "l_extendedprice" in need:
        p = ints["l_partkey"]
        retail = 90000 + (p // 10) % 20001 + 100 * (p % 1000)  # P_RETAILPRICE in hundredths
        ints["l_extendedprice"] = ints["l_quantity"] * retail
    if "l_discount" in need:
        ints["l_discount"] = rng("discount").integers(0, 11, n)
    if "l_tax" in need:
        ints["l_tax"] = rng("tax").integers(0, 9, n)
    od = np.repeat(orderdate, nlines) if need & {"l_shipdate", "l_commitdate"} else None
    if "l_shipdate" in need:
        ints["l_shipdate"] = od + rng("ship").integers(1, 122, n).astype(np.int32)
    if "l_commitdate" in need:
        ints["l_commitdate"] = od + rng("commit").integers(30, 91, n).astype(np.int32)
    if "l_receiptdate" in need:
        ints["l_receiptdate"] = ints["l_shipdate"] + rng("receipt").integers(1, 31, n).astype(np.int32)
    if "l_returnflag" in need:
        ra = np.where(rng("flag").integers(0, 2, n) == 1, 2, 0)  # "R" or "A"
        codes["l_returnflag"] = np.where(ints["l_receiptdate"] <= CURRENTDATE, ra, 1).astype(np.int8)
    if "l_linestatus" in need:
        codes["l_linestatus"] = (ints["l_shipdate"] > CURRENTDATE).astype(np.int8)
    if "l_shipinstruct" in need:
        codes["l_shipinstruct"] = rng("shipinstruct").integers(0, len(SHIPINSTRUCTS), n).astype(np.int8)
    if "l_shipmode" in need:
        codes["l_shipmode"] = rng("shipmode").integers(0, len(SHIPMODES), n).astype(np.int8)
    if "l_comment" in need:
        if pool is None:
            raise ValueError("l_comment needs the text pool")
        texts["l_comment"] = text.text_strings(rng("comment"), pool, n, *COMMENT_BYTES)
    keep = set(columns)
    return Lineitem(n, {k: v for k, v in ints.items() if k in keep},
                    {k: v for k, v in codes.items() if k in keep},
                    {k: v for k, v in texts.items() if k in keep})


def concatenate(parts: Sequence[Lineitem]) -> Lineitem:
    """One table of the rows of ``parts``, in order (integer and coded
    columns only)."""
    first = parts[0]
    if first.texts:
        raise ValueError("concatenate takes no text columns")
    return Lineitem(sum(p.rows for p in parts),
                    {k: np.concatenate([p.ints[k] for p in parts]) for k in first.ints},
                    {k: np.concatenate([p.codes[k] for p in parts]) for k in first.codes}, {})


def generate_lineitem(seed: int, scale: float, orders_per_slice: int,
                      slices: Optional[Iterable[int]] = None,
                      columns: Sequence[str] = COLUMNS) -> Lineitem:
    """The table of ``slices`` (default: every slice of the scale
    factor's ``scale * 1,500,000`` orders), integer and coded columns,
    the slices made in threads."""
    if slices is None:
        slices = range(-(-int(scale * ORDERS_PER_SF) // orders_per_slice))
    # numpy's draws and arithmetic let go of the GIL: slices in threads
    with cf.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(
            lambda s: generate_slice(seed, scale, s, orders_per_slice, columns), slices))
    return concatenate(parts)


def text_pool(size: int, cache_dir: Optional[str] = None) -> np.ndarray:
    """The text pool of ``size`` bytes, one text for every seed as dbgen's
    is.  With ``cache_dir`` it is kept there as a file and read back."""
    if cache_dir is None:
        return text.text_pool(_TEXT_POOL_SEED, size)
    path = os.path.join(cache_dir, f"tpch_text_pool_{size}.u8")
    if os.path.exists(path) and os.path.getsize(path) == size:
        return np.fromfile(path, dtype=np.uint8)
    pool = text.text_pool(_TEXT_POOL_SEED, size)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.part"
    pool.tofile(tmp)
    os.replace(tmp, path)
    return pool

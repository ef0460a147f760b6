"""TPC-H lineitem and orders, Q1, Q6 and a Q3-shaped join.

Counterpart of ``strawboat_tpu/benchsuite/tpch.py``.  The generators are
the reference's numpy bodies and return numpy columns (no pyarrow needed);
the numpy references compute Q1 over dictionary codes, which stays fast at
60 M rows.  Money columns are scaled int64 (cents), so every sum is an
exact integer.

The four money columns also come typed (:func:`typed_money`), as users of
the format hold them: ``"decimal"`` is ``decimal128(15, 2)``, TPC-H's own
type (unscaled int64 on the device, every sum exact), and ``"float64"``
the Float64 cast of the pola-rs PDS-H data preparation (sums match to
rtol 1e-12).  Q1 and Q6 take the layout as ``money``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from ..exec.aggregate import grouped_aggregate
from ..exec.expr import col
from ..exec.join import hash_join
from ..exec.pruning import Comparison
from ..exec.query import Query
from ..exec.resident import ResidentTable

ROWS_PER_SF = 6_000_000
EPOCH_DAYS = 2557  # 1992-01-01 .. 1998-12-31
Q1_DEFAULT_DELTA = 90

_RETURNFLAGS = np.array(["A", "N", "R"])
_SHIPMODES = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"])

Q1_AGG_NAMES = (
    "sum_qty",
    "sum_base_price",
    "sum_disc_price",
    "sum_charge",
    "avg_qty",
    "avg_price",
    "avg_disc",
    "count_order",
)
# the columns Q1 and Q6 read
Q1_Q6_COLUMNS = (
    "l_quantity",
    "l_extendedprice",
    "l_discount",
    "l_tax",
    "l_returnflag",
    "l_linestatus",
    "l_shipdate",
)
# the integer columns
INT_COLUMNS = (
    "l_orderkey",
    "l_suppkey",
    "l_quantity",
    "l_extendedprice",
    "l_discount",
    "l_tax",
    "l_shipdate",
)
MONEY_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
MONEY_DECIMAL = "decimal128(15, 2)"
MONEY_LAYOUTS = ("int", "decimal", "float64")
# every column, in the generator's order: seven integer, three utf8
LINEITEM_COLUMNS = (
    "l_orderkey",
    "l_suppkey",
    "l_quantity",
    "l_extendedprice",
    "l_discount",
    "l_tax",
    "l_returnflag",
    "l_linestatus",
    "l_shipmode",
    "l_shipdate",
)


def generate_lineitem(
    scale: float, seed: int = 0, rows: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """dbgen-shaped lineitem as numpy columns (seeded; the same values as
    the reference generator's arrow table)."""
    n = rows if rows is not None else int(ROWS_PER_SF * scale)
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n).astype(np.int64)  # 1..50
    extendedprice = (quantity * rng.integers(90000, 110001, n)).astype(np.int64)
    discount = rng.integers(0, 11, n).astype(np.int64)  # 0.00..0.10 (hundredths)
    tax = rng.integers(0, 9, n).astype(np.int64)
    # shipdate: days since 1992-01-01, clustered by order date over 7 years
    shipdate = np.sort(rng.integers(0, EPOCH_DAYS, n)).astype(np.int32)
    jitter = rng.integers(0, 122, n).astype(np.int32)
    shipdate = shipdate + jitter
    returnflag = rng.choice(_RETURNFLAGS, n, p=[0.25, 0.5, 0.25])
    linestatus = np.where(shipdate > 2190, "O", "F")
    shipmode = rng.choice(_SHIPMODES, n)
    orderkey = np.repeat(np.arange(max(n // 4, 1), dtype=np.int64), 4)[:n]
    suppkey = rng.integers(0, max(int(10000 * max(scale, 0.01)), 10), n).astype(np.int64)
    return {
        "l_orderkey": orderkey,
        "l_suppkey": suppkey,
        "l_quantity": quantity,
        "l_extendedprice": extendedprice,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipmode": shipmode,
        "l_shipdate": shipdate,
    }


# ---------------------------------------------------------------------------
# Q6: revenue from discounted small shipments in 1994


def typed_money(cols: Dict[str, np.ndarray], money: str) -> Dict[str, np.ndarray]:
    """The columns with the money columns in the ``money`` layout: "int"
    as generated (quantity in units, the rest in hundredths), "decimal"
    the unscaled values of ``decimal128(15, 2)`` (quantity × 100), or
    "float64" the values as doubles (quantity as is, the rest / 100)."""
    if money not in MONEY_LAYOUTS:
        raise ValueError(f"money layout {money!r} (one of {', '.join(MONEY_LAYOUTS)})")
    out = dict(cols)
    if money == "decimal":
        out["l_quantity"] = cols["l_quantity"] * 100
    elif money == "float64":
        out["l_quantity"] = cols["l_quantity"].astype(np.float64)
        for k in MONEY_COLUMNS[1:]:
            out[k] = cols[k] / 100.0
    return out


def _write(path, cols: Dict[str, np.ndarray], max_page_size: int, options, zone_maps=False,
           schema=None):
    from ..codecs import WriteOptions
    from ..write import write_file

    if options is None:
        options = WriteOptions(max_page_size=max_page_size, zone_maps=zone_maps)
    elif zone_maps:
        raise ValueError("pass zone_maps in options, not beside them")
    return write_file(path, cols, schema=schema, options=options)


def write_lineitem(
    path,
    cols: Dict[str, np.ndarray],
    max_page_size: int = 65536,
    options=None,
    columns: Sequence[str] = LINEITEM_COLUMNS,
    zone_maps: bool = False,
    money: str = "int",
):
    """Write lineitem's ``columns`` (default: all ten, the three utf8 flags
    included) through the port's writer, codecs as the
    ``STRAWBOAT_*_COMPRESSION`` flags force them, with zone maps when
    ``zone_maps`` → column metas.  ``cols`` are as generated; ``money``
    picks the money columns' layout (:func:`typed_money`: "decimal" writes
    them as ``decimal128(15, 2)`` fields).  ``options``, when given,
    decides page size and zone maps itself; ``zone_maps=True`` beside it
    raises."""
    from ..schema import Field
    from ..write.writer import _numpy_alias

    typed = typed_money(cols, money)
    data = {k: typed[k] for k in columns}
    schema = None
    if money == "decimal":
        schema = [Field(k, MONEY_DECIMAL if k in MONEY_COLUMNS else _numpy_alias(v))
                  for k, v in data.items()]
    return _write(path, data, max_page_size, options, zone_maps, schema)


# Q6's literals per money layout: discount in [lo, hi] (TPC-H's 0.06 ± 0.01
# written as the two literals, since 0.06 + 0.01 is not 0.07 in float64),
# quantity below the third
Q6_LITERALS = {"int": (5, 7, 24), "decimal": (5, 7, 2400), "float64": (0.05, 0.07, 24.0)}


def q6(table, money: str = "int"):
    """TPC-H Q6: shipdate in [1994, 1995), discount in [0.05, 0.07],
    quantity < 24; sum(extendedprice * discount) as an int64 scalar
    (unscaled for "decimal", a float64 for "float64").

    A resident table runs its fused ``filter_sum``; a scanned
    ``DeviceTable`` runs a few torch ops (compare, ``where``, product,
    ``sum``), as the reference's ``q6(table)`` does."""
    d_lo, d_hi, q_hi = Q6_LITERALS[money]
    if isinstance(table, ResidentTable):
        # half-open bounds: the least value above d_hi closes the range
        upper = np.nextafter(d_hi, np.inf) if money == "float64" else d_hi + 1
        return table.filter_sum(
            {"l_shipdate": (731, 1096), "l_discount": (d_lo, upper), "l_quantity": (None, q_hi)},
            value="l_extendedprice",
            product_with="l_discount",
        )
    sd = table["l_shipdate"].values
    disc = table["l_discount"].values
    qty = table["l_quantity"].values
    ep = table["l_extendedprice"].values
    m = (sd >= 731) & (sd < 1096) & (disc >= d_lo) & (disc <= d_hi) & (qty < q_hi)
    if money == "float64":
        return torch.where(m, ep * disc, 0.0).sum(dtype=torch.float64)
    prod = ep.to(torch.int64) * disc.to(torch.int64)
    return torch.where(m, prod, 0).sum(dtype=torch.int64)


def q6_pruning_predicates():
    """Q6's l_shipdate range as pruning atoms for ``scan_file``."""
    return [Comparison("l_shipdate", "ge", 731), Comparison("l_shipdate", "lt", 1096)]


def q6_numpy_reference(cols: Dict[str, np.ndarray], money: str = "int"):
    """Q6 in numpy over generated columns (typed as ``money`` here)."""
    cols = typed_money(cols, money)
    d_lo, d_hi, q_hi = Q6_LITERALS[money]
    sd, disc = cols["l_shipdate"], cols["l_discount"]
    qty, ep = cols["l_quantity"], cols["l_extendedprice"]
    m = (sd >= 731) & (sd < 1096) & (disc >= d_lo) & (disc <= d_hi) & (qty < q_hi)
    if money == "float64":
        return float((ep[m] * disc[m]).sum())
    return int((ep[m].astype(np.int64) * disc[m]).sum())


# ---------------------------------------------------------------------------
# Q1: pricing summary, all 8 aggregates, grouped by the two string flags


def q1_aggs(money: str = "int"):
    one = 1 if money == "float64" else 100  # 1.00 at the layout's scale
    disc_price = col("l_extendedprice") * (one - col("l_discount"))
    charge = disc_price * (one + col("l_tax"))
    return {
        "sum_qty": ("sum", "l_quantity"),
        "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", disc_price),
        "sum_charge": ("sum", charge),
        "avg_qty": ("avg", "l_quantity"),
        "avg_price": ("avg", "l_extendedprice"),
        "avg_disc": ("avg", "l_discount"),
        "count_order": ("count", "l_quantity"),
    }


def _q1(source, delta_days: int, device=None, money: str = "int"):
    q = Query(source) if device is None else Query(source, device=device)
    return (
        q.filter(col("l_shipdate") <= EPOCH_DAYS - delta_days)
        .group_by("l_returnflag", "l_linestatus", num_groups=16)
        .agg(**q1_aggs(money))
        .order_by("key_l_returnflag", "key_l_linestatus")
        .run()
    )


def q1(table, delta_days: int = Q1_DEFAULT_DELTA, money: str = "int"):
    """TPC-H Q1 through the fluent Query API, ordered by the group keys: a
    resident table takes the fused branch, a scanned ``DeviceTable`` the
    sort-based ``hash_aggregate``."""
    return _q1(table, delta_days, money=money)


def q1_query(path: str, device, delta_days: int = Q1_DEFAULT_DELTA, money: str = "int"):
    """Q1 over a file on ``device``: the scan reads the seven columns Q1
    needs, its pages pruned by the l_shipdate filter's zone maps, and the
    string keys order lexically."""
    return _q1(path, delta_days, device, money)


def _key_str(dictionary, code) -> str:
    v = dictionary[int(code)]
    return v.decode() if isinstance(v, bytes) else str(v)


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.asarray(x).dtype.kind == "f"


def q1_rows(res) -> Dict[Tuple[str, str], Dict[str, float]]:
    """A grouped Q1 result → {(returnflag, linestatus): {aggregate: value}}
    (float aggregates as ``float``, the others as ``int``); keys decode
    from a ``str`` (resident) or ``bytes`` (scanned) dictionary."""
    out = {}
    for i in range(int(res["n_groups"])):
        flag = _key_str(res["dict_l_returnflag"], res["key_l_returnflag"][i])
        status = _key_str(res["dict_l_linestatus"], res["key_l_linestatus"][i])
        out[(flag, status)] = {
            name: (float if _is_float(res[name]) else int)(res[name][i])
            for name in Q1_AGG_NAMES
        }
    return out


def dictionary_codes(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted distinct values, int64 code per row) of a numpy column.
    One-character strings take an O(n) count over their code points."""
    if arr.dtype.kind == "U" and arr.dtype.itemsize == 4 and len(arr):
        cp = arr.view(np.uint32)
        present = np.flatnonzero(np.bincount(cp))
        rank = np.zeros(int(present[-1]) + 1, dtype=np.int64)
        rank[present] = np.arange(len(present))
        return present.astype(np.uint32).view(arr.dtype), rank[cp]
    uniq, codes = np.unique(arr, return_inverse=True)
    return uniq, codes.astype(np.int64)


def q1_numpy_reference(
    cols: Dict[str, np.ndarray], delta_days: int = Q1_DEFAULT_DELTA, money: str = "int"
) -> Dict[Tuple[str, str], Dict[str, float]]:
    """Q1 in numpy over dictionary codes of generated columns (typed as
    ``money`` here): exact int64 sums, float64 sums for "float64";
    averages are the float64 quotient of the sum by the count."""
    cols = typed_money(cols, money)
    one = 1 if money == "float64" else 100
    num = float if money == "float64" else int
    rf_vals, rf = dictionary_codes(cols["l_returnflag"])
    ls_vals, ls = dictionary_codes(cols["l_linestatus"])
    qty, ep = cols["l_quantity"], cols["l_extendedprice"]
    disc, tax = cols["l_discount"], cols["l_tax"]
    m = cols["l_shipdate"] <= (EPOCH_DAYS - delta_days)
    group = np.where(m, rf * len(ls_vals) + ls, -1)
    out = {}
    for gi in range(len(rf_vals) * len(ls_vals)):
        g = group == gi
        n = int(g.sum())
        if not n:
            continue
        q, e, d, t = qty[g], ep[g], disc[g], tax[g]
        dp = e * (one - d)
        ch = dp * (one + t)
        sums = {
            "sum_qty": num(q.sum()),
            "sum_base_price": num(e.sum()),
            "sum_disc_price": num(dp.sum()),
            "sum_charge": num(ch.sum()),
        }
        key = (str(rf_vals[gi // len(ls_vals)]), str(ls_vals[gi % len(ls_vals)]))
        out[key] = {
            **sums,
            "avg_qty": sums["sum_qty"] / n,
            "avg_price": sums["sum_base_price"] / n,
            "avg_disc": num(d.sum()) / n,
            "count_order": n,
        }
    return out


# ---------------------------------------------------------------------------
# orders and a Q3-shaped join: lineitem ⋈ orders on the order key, a date
# filter on orders, revenue grouped by order priority


def generate_orders(
    scale: float, seed: int = 1, rows: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Orders (1.5 M rows per SF) as numpy columns, the reference
    generator's values: o_orderkey is ``arange``, aligned with lineitem's
    order keys; o_orderpriority is a low-cardinality int (1..5)."""
    n = rows if rows is not None else int(1_500_000 * scale)
    rng = np.random.default_rng(seed)
    orderkey = np.arange(n, dtype=np.int64)
    custkey = rng.integers(0, max(int(150_000 * max(scale, 0.01)), 10), n).astype(np.int64)
    orderdate = rng.integers(0, EPOCH_DAYS - 151, n).astype(np.int32)
    priority = rng.integers(1, 6, n).astype(np.int64)
    return {
        "o_orderkey": orderkey,
        "o_custkey": custkey,
        "o_orderdate": orderdate,
        "o_orderpriority": priority,
    }


def write_orders(path, cols: Dict[str, np.ndarray], max_page_size: int = 65536, options=None):
    """Write the orders columns through the port's writer → column metas."""
    return _write(path, cols, max_page_size, options)


# orders with their lineitems nested: one row per order, the order's
# lineitems as a list of structs (the denormalized layout nested formats
# were made for), and its prices as a list of int64
NESTED_LINEITEM = ("l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                   "l_returnflag")


def nested_orders(orders: Dict[str, np.ndarray], lineitem: Dict[str, np.ndarray],
                  offsets: np.ndarray):
    """Order ``i`` owns lineitem rows ``[offsets[i], offsets[i + 1])`` →
    (columns, fields) for ``write_file``: the orders columns, then
    ``o_lineitems`` (list<struct<l_quantity, l_extendedprice, l_discount,
    l_tax int64, l_shipdate date32, l_returnflag utf8>>) and
    ``o_lineprices`` (list<int64>, each order's l_extendedprice)."""
    from .. import columns as cm
    from ..schema import Field, list_of
    from ..write.writer import _binary_column, _numpy_alias

    m = int(offsets[-1])
    flag = _binary_column(lineitem["l_returnflag"][:m], None)
    leaves = [cm.PrimitiveColumn("date32" if k == "l_shipdate" else "int64", None, lineitem[k][:m])
              for k in NESTED_LINEITEM[:-1]]
    leaves.append(cm.BinaryColumn("string", None, flag.offsets, flag.values))
    item = Field("item", "struct", True, tuple(
        Field(k, c.dtype) for k, c in zip(NESTED_LINEITEM, leaves)))
    cols = dict(orders)
    cols["o_lineitems"] = cm.ListColumn("list", None, offsets, cm.StructColumn("struct", None, leaves, m))
    cols["o_lineprices"] = cm.ListColumn(
        "list", None, offsets, cm.PrimitiveColumn("int64", None, lineitem["l_extendedprice"][:m]))
    fields = [Field(k, _numpy_alias(v)) for k, v in orders.items()]
    fields += [list_of("o_lineitems", item), list_of("o_lineprices", Field("item", "int64"))]
    return cols, fields


def q3_like(lineitem, orders, date_cut: int = 1000, num_groups: int = 8192):
    """Q3-shaped query over two DeviceTables: join lineitem → orders on the
    order key (orders is the unique-key build side), keep orders before
    ``date_cut``, sum ``l_extendedprice * (100 - l_discount)`` by
    o_orderpriority.  Returns (label keys, n_groups, revenue) device
    tensors, slot for slot the reference's."""
    pi, bi, valid = hash_join(lineitem, orders, on=("l_orderkey", "o_orderkey"))
    valid = valid & (orders["o_orderdate"].values[bi] < date_cut)
    revenue = lineitem["l_extendedprice"].values[pi].long() * (
        100 - lineitem["l_discount"].values[pi].long()
    )
    prio = orders["o_orderpriority"].values[bi]
    uniq, n_groups, _rep, (total,) = grouped_aggregate(
        (prio,), (revenue,), valid, num_groups, (("sum", 0),)
    )
    return uniq, n_groups, total


def q3_query(lineitem, orders, device, date_cut: int = 1000):
    """The Q3-shaped join through the Query API (files or resident
    tables): lineitem ⋈ orders filtered on o_orderdate, revenue grouped by
    o_orderpriority."""
    return (
        Query(lineitem, device=device)
        .join(Query(orders, device=device).filter(col("o_orderdate") < date_cut),
              on=("l_orderkey", "o_orderkey"))
        .group_by("o_orderpriority", num_groups=64)
        .agg(revenue=("sum", col("l_extendedprice") * (100 - col("l_discount"))))
        .run()
    )


def q3_rows(keys: torch.Tensor, n_groups, revenue: torch.Tensor) -> Dict[int, int]:
    """{priority: revenue} from a grouped result's first ``n_groups``
    slots."""
    n = int(n_groups)
    return dict(zip(keys[:n].tolist(), revenue[:n].tolist()))


def q3_numpy_reference(
    li: Dict[str, np.ndarray], orders: Dict[str, np.ndarray], date_cut: int = 1000
) -> Dict[int, int]:
    """{priority: revenue} in numpy: each lineitem row finds its order by
    ``searchsorted`` over the sorted o_orderkey."""
    lk, ok = li["l_orderkey"], orders["o_orderkey"]
    pos = np.clip(np.searchsorted(ok, lk), 0, len(ok) - 1)
    matched = (ok[pos] == lk) & (orders["o_orderdate"][pos] < date_cut)
    rev = li["l_extendedprice"] * (100 - li["l_discount"])
    prio = orders["o_orderpriority"][pos]
    out = {}
    for g in np.unique(orders["o_orderpriority"]):
        m = matched & (prio == g)
        if m.any():
            out[int(g)] = int(rev[m].sum())
    return out

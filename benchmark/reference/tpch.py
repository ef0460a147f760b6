"""Plain NumPy answers of TPC-H Q1 and Q6 over generated lineitem columns.

Each class sums the generated columns once into exact int64 tables (by
ship date, and for Q6 by discount and quantity too), and then answers any
query parameter from the table, so that every answer of a run can be
checked.  Money is in hundredths as generated; every sum is an exact
integer.  ``dtype=np.int32`` computes the same answers in 32-bit integer
arithmetic, products and sums wrapping as int32 does: the control, the
next integer precision below the int64 the configuration states.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .lineitem import LINESTATUSES, RETURNFLAGS, Lineitem

Q1_CUT = 2526  # 1998-12-01, days since 1992-01-01 (clause 2.4.1)

Q1_SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge")
Q1_AVGS = {"avg_qty": "sum_qty", "avg_price": "sum_base_price", "avg_disc": "sum_disc"}
Q1_NAMES = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_price", "avg_disc", "count_order")
ONE = 100  # 1.00 in hundredths


def exact_bincount(bins: np.ndarray, values: np.ndarray, size: int) -> np.ndarray:
    """Per-bin sums of non-negative int64 ``values`` below 2**53, exact:
    the low and high 32 bits are summed apart in float64, where each
    partial sum stays an exact integer while a bin holds under 2**21 rows."""
    v = values.astype(np.int64, copy=False)
    if len(v) and int(v.min()) < 0:
        raise ValueError("exact_bincount takes non-negative values")
    lo = np.bincount(bins, weights=(v & 0xFFFFFFFF).astype(np.float64), minlength=size)
    hi = np.bincount(bins, weights=(v >> 32).astype(np.float64), minlength=size)
    return (hi.astype(np.int64) << 32) + lo.astype(np.int64)


def _wrap32(x):
    """An exact integer reduced as int32 arithmetic would leave it."""
    return ((np.asarray(x, dtype=np.int64) + 2**31) % 2**32) - 2**31


def year_start(year: int) -> int:
    """Days from 1992-01-01 to January 1st of ``year``."""
    return sum(366 if y % 4 == 0 else 365 for y in range(1992, year))


class Q1Reference:
    """Q1 (``l_shipdate <= 1998-12-01 - delta``, grouped by return flag and line
    status) for every delta, from exact sums by (group, ship date)."""

    def __init__(self, li: Lineitem, dtype=np.int64):
        self.int32 = np.dtype(dtype) == np.int32
        sd = li.ints["l_shipdate"].astype(np.int64)
        self.days = int(sd.max()) + 1 if len(sd) else 1
        rf, ls = li.codes["l_returnflag"].astype(np.int64), li.codes["l_linestatus"].astype(np.int64)
        self.n_ls = len(LINESTATUSES)
        self.n_groups = len(RETURNFLAGS) * self.n_ls
        bins = (rf * self.n_ls + ls) * self.days + sd
        size = self.n_groups * self.days
        qty, ep = li.ints["l_quantity"], li.ints["l_extendedprice"]
        disc, tax = li.ints["l_discount"], li.ints["l_tax"]
        if self.int32:
            qty, ep, disc, tax = (a.astype(np.int32) for a in (qty, ep, disc, tax))
        disc_price = ep * (ONE - disc)
        charge = disc_price * (ONE + tax)

        def table(v):
            # int32 products wrap: add their two's complement bits exactly
            v = v.astype(np.int64) & 0xFFFFFFFF if self.int32 else v
            t = exact_bincount(bins, v, size).reshape(self.n_groups, self.days)
            return np.cumsum(t, axis=1)

        self.prefix = {"sum_qty": table(qty), "sum_base_price": table(ep),
                       "sum_disc_price": table(disc_price), "sum_charge": table(charge),
                       "sum_disc": table(disc)}
        self.count = np.cumsum(np.bincount(bins, minlength=size).reshape(self.n_groups, self.days),
                               axis=1)

    def answer(self, delta: int) -> Dict[Tuple[str, str], Dict[str, float]]:
        """{(returnflag, linestatus): {aggregate: value}} for ``delta``:
        sums and counts as ``int``, averages as the quotient of the sum by
        the count."""
        cut = min(Q1_CUT - delta, self.days - 1)
        out = {}
        if cut < 0:
            return out
        for g in range(self.n_groups):
            n = int(self.count[g, cut])
            if not n:
                continue
            sums = {k: int(v[g, cut]) for k, v in self.prefix.items()}
            if self.int32:
                sums = {k: int(_wrap32(v)) for k, v in sums.items()}
            row = {k: sums[k] for k in Q1_SUMS}
            row.update({k: sums[s] / n for k, s in Q1_AVGS.items()})
            row["count_order"] = n
            out[(str(RETURNFLAGS[g // self.n_ls]), str(LINESTATUSES[g % self.n_ls]))] = row
        return out


class Q6Reference:
    """Q6 (``l_shipdate`` in [Jan 1st of year, of year + 1), ``l_discount``
    in [d - 1, d + 1] hundredths, ``l_quantity < q``; the sum of
    ``l_extendedprice * l_discount``) for every parameter, from exact sums
    by ship date, discount and quantity."""

    def __init__(self, li: Lineitem, dtype=np.int64):
        self.int32 = np.dtype(dtype) == np.int32
        sd = li.ints["l_shipdate"].astype(np.int64)
        disc, qty = li.ints["l_discount"], li.ints["l_quantity"]
        ep = li.ints["l_extendedprice"]
        self.days = int(sd.max()) + 1 if len(sd) else 1
        self.n_disc = int(disc.max()) + 1 if len(disc) else 1
        self.n_qty = int(qty.max()) + 1 if len(qty) else 1
        bins = (sd * self.n_disc + disc) * self.n_qty + qty
        prod = ep.astype(np.int32) * disc.astype(np.int32) if self.int32 else ep * disc
        if self.int32:
            prod = prod.astype(np.int64) & 0xFFFFFFFF
        size = self.days * self.n_disc * self.n_qty
        t = exact_bincount(bins, prod, size).reshape(self.days, self.n_disc, self.n_qty)
        self.prefix = np.concatenate([np.zeros((1, self.n_disc, self.n_qty), np.int64),
                                      np.cumsum(t, axis=0)])

    def answer(self, year: int, discount: int, quantity: int) -> int:
        lo = min(max(year_start(year), 0), self.days)
        hi = min(max(year_start(year + 1), 0), self.days)
        by = self.prefix[hi] - self.prefix[lo]
        d0, d1 = max(discount - 1, 0), min(discount + 1, self.n_disc - 1)
        q1 = min(max(quantity, 0), self.n_qty)
        s = int(by[d0 : d1 + 1, :q1].sum()) if d1 >= d0 else 0
        return int(_wrap32(s)) if self.int32 else s

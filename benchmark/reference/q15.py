"""Plain answers of TPC-H Q15 (clause 2.4.15) over generated lineitem rows.

The ``revenue`` view sums ``l_extendedprice * (1 - l_discount)`` by
``l_suppkey`` over the ship dates of one quarter, [DATE, DATE + 3
months); the answer is the view's largest ``total_revenue`` and every
supplier holding it, by ``s_suppkey``.  Money is in hundredths as
generated, so a row's revenue is ``l_extendedprice * (100 - l_discount)``
in ten-thousandths, an exact integer.

:class:`Q15Reference` sums every row once into an exact int64 table by
(month of the ship date, supplier), slice by slice from the benchmark's
generator, so that host memory holds the table (months × suppliers) and
a few slices, never the whole table of rows; then it answers any DATE
from the table.  It uses NumPy on the host only, and nothing of the
program under test.  ``answer(month, int32=True)`` gives the answers of
the same sums in 32-bit integer arithmetic (a row's revenue, below
2**31, fits; the sums wrap as int32 does): the control.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, List

import numpy as np

from .lineitem import ENDDATE, ORDERS_PER_SF, SUPPLIERS_PER_SF, generate_slice
from .tpch import _wrap32

COLUMNS = ("l_suppkey", "l_extendedprice", "l_discount", "l_shipdate")
ONE = 100  # 1.00 in hundredths

_DAYS = np.arange("1992-01-01", "1999-02-01", dtype="datetime64[D]")
# month of each day since 1992-01-01, counted from 1992-01
MONTH_OF_DAY = (_DAYS.astype("datetime64[M]") - np.datetime64("1992-01", "M")).astype(np.int64)
assert len(MONTH_OF_DAY) > ENDDATE


def month_start(month: int) -> int:
    """Days from 1992-01-01 to the first day of ``month`` (months since
    1992-01)."""
    return int(np.searchsorted(MONTH_OF_DAY, month, "left"))


def quarter(month: int):
    """Q15's ship-date bounds for DATE the first of ``month``: the
    half-open [DATE, DATE + 3 months) in days since 1992-01-01."""
    return month_start(month), month_start(month + 3)


def slices_of(cfg: dict) -> List[int]:
    """Every slice of a configuration's table."""
    orders = int(cfg.get("orders", float(cfg["scale"]) * ORDERS_PER_SF))
    return list(range(-(-orders // int(cfg["orders_per_slice"]))))


class Q15Reference:
    """Q15 for every DATE of the configuration's table from ``seed``:
    ``table[m, s]`` is supplier ``s``'s exact revenue over the rows
    shipped in month ``m``."""

    def __init__(self, cfg: dict, seed: int):
        scale = float(cfg["scale"])
        per = int(cfg["orders_per_slice"])
        self.suppliers = int(scale * SUPPLIERS_PER_SF)
        self.months = int(MONTH_OF_DAY[ENDDATE]) + 1
        # month-major, so that a quarter's sums read three contiguous rows
        table = np.zeros(self.months * (self.suppliers + 1), dtype=np.int64)
        todo = slices_of(cfg)

        def make(i):
            li = generate_slice(seed, scale, i, per, COLUMNS)
            month = MONTH_OF_DAY[li.ints["l_shipdate"]]
            bins = month * (self.suppliers + 1) + li.ints["l_suppkey"]
            rev = li.ints["l_extendedprice"] * (ONE - li.ints["l_discount"])
            # sorted by bin, the table's adds walk it in order
            order = np.argsort(bins)
            return bins[order], rev[order]

        workers = min(16, os.cpu_count() or 1)
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            # a bounded window of slices in flight keeps host memory small
            pending = [ex.submit(make, i) for i in todo[:workers]]
            nxt = len(pending)
            while pending:
                bins, rev = pending.pop(0).result()
                if nxt < len(todo):
                    pending.append(ex.submit(make, todo[nxt]))
                    nxt += 1
                np.add.at(table, bins, rev)
        self.table = table.reshape(self.months, self.suppliers + 1)
        self._answers: Dict = {}

    def answer(self, month: int, int32: bool = False) -> Dict:
        """``{"revenue": the largest total_revenue (ten-thousandths) or None,
        "suppliers": [s_suppkey, ...] ascending}`` for DATE the first of
        ``month`` (months since 1992-01); ``int32`` wraps the sums as int32
        arithmetic does (the control).  Each answer is computed once."""
        key = (int(month), bool(int32))
        if key not in self._answers:
            self._answers[key] = self._answer(*key)
        return self._answers[key]

    def _answer(self, month: int, int32: bool) -> Dict:
        quarter_rows = self.table[month : month + 3]
        rev = quarter_rows.sum(axis=0)
        if int32:
            rev = _wrap32(rev)
        present = quarter_rows.any(axis=0)
        if not present.any():
            return {"revenue": None, "suppliers": []}
        rev[~present] = np.iinfo(np.int64).min
        best = int(rev.max())
        return {"revenue": best, "suppliers": np.flatnonzero(rev == best).tolist()}


def q15_gaps(pairs) -> Dict[str, int]:
    """Over (got, want) answers: ``revenue_gap``, the widest gap of the
    largest revenue (an answer that has none where the other has one
    counts as 2**63 - 1); ``suppliers_wrong``, the suppliers one side
    lists and the other lacks, summed over the answers."""
    gap, wrong = 0, 0
    for got, want in pairs:
        g, w = got["revenue"], want["revenue"]
        if g is None or w is None:
            gap = max(gap, 0 if g is w else (1 << 63) - 1)
        else:
            gap = max(gap, abs(int(g) - int(w)))
        wrong += len(set(got["suppliers"]) ^ set(want["suppliers"]))
    return {"revenue_gap": gap, "suppliers_wrong": wrong}

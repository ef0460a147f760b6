"""TPC-H Q6 over the resident lineitem table, through the fused
``ResidentTable.filter_sum``: ship date in the year, discount within one
hundredth of ``discount``, quantity below ``quantity``; the sum of
``l_extendedprice * l_discount`` fetched to the host."""

from __future__ import annotations

from benchmark.lib.program import resident_planes
from benchmark.reference.compare import scalar_gap
from benchmark.reference.tpch import Q6Reference, year_start

COLUMNS = ("l_discount", "l_extendedprice", "l_quantity", "l_shipdate")
LIMITS = {"revenue_gap": 0}  # the revenue is an exact integer


def prepare(data, cfg, traffic, device, workdir):
    return data.resident


def run(rt, p):
    y, d = int(p["year"]), int(p["discount"])
    return int(rt.filter_sum(
        {"l_shipdate": (year_start(y), year_start(y + 1)),
         "l_discount": (d - 1, d + 2),
         "l_quantity": (None, int(p["quantity"]))},
        value="l_extendedprice", product_with="l_discount"))


def facts(rt, params):
    return {"k1_planes_per_op": resident_planes(rt, COLUMNS)}


def check(data, traffic, done, device):
    ref = Q6Reference(data.table)
    return {"revenue_gap": scalar_gap(
        (ans, ref.answer(int(p["year"]), int(p["discount"]), int(p["quantity"])))
        for p, ans in done)}


def control(data, cfg, traffic, params, device, workdir):
    """The reference in int32 in the program's place: its answers to
    ``params``, judged as the program's are."""
    low = Q6Reference(data.table, dtype="int32")
    return check(data, traffic, [(p, low.answer(int(p["year"]), int(p["discount"]),
                                                int(p["quantity"]))) for p in params], device)

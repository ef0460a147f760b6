"""TPC-H Q15 (clause 2.4.15) over lineitem held resident across a world of
processes, one card each (``benchmark/setups/lineitem_world.py``).

The ``revenue`` view, ``sum(l_extendedprice * (1 - l_discount))`` by
``l_suppkey`` over the ship dates of [DATE, DATE + 3 months), and its
largest ``total_revenue`` with every supplier holding it, through the
program's ``sharded_keyed_aggregate``: every rank decodes and filters its
own rows, pre-aggregates by supplier, the partial groups cross the world
in a keyed exchange, each rank combines the suppliers it owns, and one
MAX all-reduce and a gather give the answer.  Rank 0 sends the parameter
to the other ranks (:meth:`Data.send`), makes the same call and returns
``{"revenue", "suppliers"}`` on the host; ``revenue`` is in
ten-thousandths (hundredths of money times hundredths of discount).
"""

from __future__ import annotations

from benchmark.reference.q15 import ONE, Q15Reference, q15_gaps, quarter

NAME = "sharded_q15"
COLUMNS = ("l_suppkey", "l_extendedprice", "l_discount", "l_shipdate")
# the revenue and the suppliers holding it are exact
LIMITS = {"revenue_gap": 0, "suppliers_wrong": 0}


def on_rank(srt, p):
    """Every rank's call for parameter ``p``: the answer of the world, on
    every rank."""
    from strawboat_tpu_torch.exec import col
    from strawboat_tpu_torch.parallel import sharded_keyed_aggregate

    revenue = col("l_extendedprice") * (ONE - col("l_discount"))
    res = sharded_keyed_aggregate(srt, "l_suppkey", {"revenue": ("sum", revenue)},
                                  {"l_shipdate": quarter(int(p["month"]))}, max_of="revenue")
    return res["max"]


def prepare(data, cfg, traffic, device, workdir):
    return data


def run(data, p):
    data.send(NAME, p)
    top = on_rank(data.srt, p)
    return {"revenue": top["value"], "suppliers": list(top["keys"])}


def facts(data, params):
    """Rank 0's planes of the columns a query reads: what one query hands
    kernel K1 on rank 0."""
    out = []
    for n in COLUMNS:
        for c in data.srt.columns[n].local:
            out.extend(tuple(w.shape) for w, _b in c.planes)
            if c.validity_plane is not None:
                out.append(tuple(c.validity_plane.shape))
    return {"k1_planes_per_op": out}


def check(data, traffic, done, device):
    ref = Q15Reference(data.cfg, data.seed)
    return q15_gaps((ans, ref.answer(int(p["month"]))) for p, ans in done)


def control(data, cfg, traffic, params, device, workdir):
    """The reference in int32 in the program's place: its answers to
    ``params`` (the same exact table, each sum wrapped as int32 does),
    judged as the program's are."""
    ref = Q15Reference(cfg, data.seed)
    return q15_gaps((ref.answer(int(p["month"]), int32=True), ref.answer(int(p["month"])))
                    for p in params)

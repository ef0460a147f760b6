"""TPC-H Q1 over the resident lineitem table, through ``Query``'s fused
resident branch: ``l_shipdate <= 1998-12-01 - delta``, grouped by return flag
and line status, the eight aggregates, ordered by the keys.  The answer
comes back to the host as one fetch; it is turned into
{(flag, status): {aggregate: value}} inside the timed call."""

from __future__ import annotations

from benchmark.lib.program import resident_planes
from benchmark.reference.compare import q1_gaps
from benchmark.reference.tpch import ONE, Q1_CUT, Q1_NAMES, Q1Reference

COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate")
# every sum and count is an exact integer; an average is the quotient of
# two exact integers, so the program's and the reference's round alike
LIMITS = {"groups_wrong": 0, "int_gap": 0, "avg_rel_gap": 1e-12}


def _aggs():
    from strawboat_tpu_torch.exec import col

    disc_price = col("l_extendedprice") * (ONE - col("l_discount"))
    return {
        "sum_qty": ("sum", "l_quantity"),
        "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", disc_price),
        "sum_charge": ("sum", disc_price * (ONE + col("l_tax"))),
        "avg_qty": ("avg", "l_quantity"),
        "avg_price": ("avg", "l_extendedprice"),
        "avg_disc": ("avg", "l_discount"),
        "count_order": ("count", "l_quantity"),
    }


def _key(dictionary, code) -> str:
    v = dictionary[int(code)]
    return v.decode() if isinstance(v, bytes) else str(v)


def prepare(data, cfg, traffic, device, workdir):
    return data.resident


def run(rt, p):
    from strawboat_tpu_torch.exec import Query, col

    res = (Query(rt)
           .filter(col("l_shipdate") <= Q1_CUT - int(p["delta"]))
           .group_by("l_returnflag", "l_linestatus", num_groups=16)
           .agg(**_aggs())
           .order_by("key_l_returnflag", "key_l_linestatus")
           .run())
    out = {}
    for i in range(int(res["n_groups"])):
        key = (_key(res["dict_l_returnflag"], res["key_l_returnflag"][i]),
               _key(res["dict_l_linestatus"], res["key_l_linestatus"][i]))
        out[key] = {n: (float(res[n][i]) if n.startswith("avg") else int(res[n][i]))
                    for n in Q1_NAMES}
    return out


def facts(rt, params):
    return {"k1_planes_per_op": resident_planes(rt, COLUMNS)}


def check(data, traffic, done, device):
    ref = Q1Reference(data.table)
    return q1_gaps((ans, ref.answer(int(p["delta"]))) for p, ans in done)


def control(data, cfg, traffic, params, device, workdir):
    """The reference in int32 in the program's place: its answers to
    ``params``, judged as the program's are."""
    low = Q1Reference(data.table, dtype="int32")
    return check(data, traffic, [(p, low.answer(int(p["delta"]))) for p in params], device)

#!/usr/bin/env python
"""Resident tables through the Query DSL on the torch port.

The port's ``examples/resident_query.py``: writes a mixed-type file
(strings, float64, integers, nulls), loads it as a resident table of
packed bit planes on the device (``load_resident``), then runs a grouped
aggregate under a string-literal filter, a LIMIT in file order, a join
with a second resident table and a grouped aggregate over the join; then
a nested file (a list column's per-row ``list_sum``, a struct's
``parent.child`` columns).  Every answer is checked against numpy (float
sums to rtol 1e-12, the rest exactly); a wrong answer exits 1.  The last
line is a JSON summary.

    python examples/torch_resident_query.py                  # on the card
    python examples/torch_resident_query.py --device cpu --rows 50000
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"WRONG: {what}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def _s(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import pyarrow as pa
    import torch

    from strawboat_tpu_torch.api import write_file
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.exec import Query, col, load_resident
    from strawboat_tpu_torch.kernels.bitunpack import launch_counts

    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(args.seed)
    n, n_cust = args.rows, 1000
    region = np.array(["emea", "apac", "amer"])[rng.integers(0, 3, n)]
    status = np.array(["open", "closed"])[rng.integers(0, 2, n)]
    amount = np.round(rng.uniform(1.0, 900.0, n), 2)
    qty = rng.integers(1, 100, n)
    day = rng.integers(0, 365, n)
    cust = rng.integers(0, n_cust + 100, n)  # 100 keys without a customer
    note_null = rng.random(n) < 0.2
    orders = pa.table({"region": region, "status": status, "amount": amount, "qty": qty,
                       "day": day, "cust": cust,
                       "note": pa.array(rng.integers(0, 50, n), mask=note_null)})
    tier = rng.integers(1, 4, n_cust)
    customers = pa.table({"cid": rng.permutation(n_cust), "tier": tier})
    out = {"script": "torch_resident_query", "device": str(device), "rows": n}
    with tempfile.TemporaryDirectory(prefix="sb_resident_") as d:
        path, cpath = os.path.join(d, "orders.str"), os.path.join(d, "customers.str")
        write_file(path, orders, options=WriteOptions(max_page_size=65536))
        write_file(cpath, customers)
        t0 = time.perf_counter()
        rt = load_resident(path, device)
        sync()
        out["load_s"] = time.perf_counter() - t0
        crt = load_resident(cpath, device)
        packed = sum(w.numel() * 4 for c in rt.columns.values() for w, _b in c.planes)
        print(f"resident: {n} rows, {packed / 1e3:.0f} KB packed on {device} "
              f"(load {out['load_s']:.2f}s)", flush=True)

        # a grouped aggregate under a string-literal predicate
        q = (Query(rt).filter((col("day") >= 90) & (col("status") == "open"))
             .group_by("region", num_groups=8)
             .agg(revenue=("sum", col("amount") * col("qty")), orders=("count", "qty")))
        res = q.run()
        t0 = time.perf_counter()
        q.run()
        sync()
        out["grouped_ms"] = (time.perf_counter() - t0) * 1e3
        sel = (day >= 90) & (status == "open")
        groups = {}
        for i in range(int(res["n_groups"])):
            name = _s(res["dict_region"][int(res["key_region"][i])])
            groups[name] = (float(res["revenue"][i]), int(res["orders"][i]))
            print(f"  {name}: revenue={groups[name][0]:.2f} orders={groups[name][1]}", flush=True)
        check(sorted(groups) == ["amer", "apac", "emea"], f"groups {sorted(groups)}")
        for r, (revenue, count) in groups.items():
            m = sel & (region == r)
            check(count == int(m.sum()), f"{r} count")
            want = float((amount[m] * qty[m]).sum())
            check(abs(revenue - want) <= 1e-12 * abs(want), f"{r} revenue {revenue} vs {want}")

        # a filter over a nullable column: null rows never pass
        notes = Query(rt).filter(col("note") < 10).agg(c=("count", "qty")).run()
        want = int((~note_null & (orders["note"].fill_null(99).to_numpy() < 10)).sum())
        check(int(notes["c"]) == want, f"note < 10: {int(notes['c'])} vs {want}")

        # LIMIT gives rows in file order (the tiled planes pre-permute)
        head, _ = Query(rt).select("day", "qty").limit(3).run()
        check(head["day"].values.cpu().tolist() == day[:3].tolist()
              and head["qty"].values.cpu().tolist() == qty[:3].tolist(), "LIMIT 3 in file order")

        # a join with the customers' resident table, grouped by tier
        jq = (Query(rt).filter(col("qty") >= 50).join(Query(crt), on=("cust", "cid"))
              .group_by("tier", num_groups=8).agg(q=("sum", "qty"), c=("count", "qty")))
        jres = jq.run()
        t0 = time.perf_counter()
        jq.run()
        sync()
        out["join_ms"] = (time.perf_counter() - t0) * 1e3
        tier_of = np.zeros(n_cust + 100, np.int64)
        tier_of[customers["cid"].to_numpy()] = tier
        m = (qty >= 50) & (cust < n_cust)
        ng = int(jres["n_groups"])
        got = {int(k): (int(a), int(b)) for k, a, b in zip(
            jres["key_tier"][:ng].tolist(), jres["q"][:ng].tolist(), jres["c"][:ng].tolist())}
        in_tier = {int(t): m & (tier_of[cust] == t) for t in np.unique(tier)}
        want = {t: (int(qty[mt].sum()), int(mt.sum())) for t, mt in in_tier.items()}
        check(got == want, f"join by tier {got} vs {want}")
        print(f"  join by tier: {got}", flush=True)

        # nested columns: a list's per-row sums, a struct's child columns
        rng2 = np.random.default_rng(args.seed + 1)
        items = [list(map(int, rng2.integers(1, 9, int(k)))) for k in rng2.integers(0, 5, 64)]
        st = pa.struct([pa.field("city", pa.string()), pa.field("zip", pa.int64())])
        addr = pa.array([{"city": ["sf", "nyc"][i % 2], "zip": 10000 + i} for i in range(64)], st)
        schema = pa.schema([pa.field("items", pa.list_(pa.int64()), nullable=False),
                            pa.field("addr", st, nullable=False)])
        nested = pa.table({"items": pa.array(items, pa.list_(pa.int64())), "addr": addr},
                          schema=schema)
        npath = os.path.join(d, "nested.str")
        write_file(npath, nested)
        rt2 = load_resident(npath, device)
        sums = rt2.list_sum("items").cpu().numpy()[:64]
        check(sums.tolist() == [sum(x) for x in items], "list_sum(items)")
        res2 = Query(rt2).filter(col("addr.city") == "sf").agg(n=("count", "addr.zip")).run()
        check(int(res2["n"]) == 32, f"addr.city == 'sf': {int(res2['n'])} rows")
        check(rt2.to_arrow().cast(schema).equals(nested), "nested table round trip")
        print(f"  list_sum(items) first 5: {sums[:5].tolist()}; addr.city == 'sf': 32 rows",
              flush=True)
    out.update(launch_counts(), ok=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

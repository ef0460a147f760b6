"""Where the general query path spends its device time, on one card.

    python3 scripts/torch_general_profile.py [--out DIR]

Builds SF10 lineitem (60 M rows, seed 0) and orders (15 M rows, seed 1)
the way ``chip_smoke.py`` does, then profiles two device-only workloads
once warm under ``torch.profiler``: ``tpch.q3_like`` over DeviceTables
already on the card, and Q1's aggregates through ``hash_aggregate`` over
the resident table (its decode included).  For each: wall time, device
busy time (the sum of the CUDA events), and the largest device entries by
name.  Then times, with CUDA events, the torch primitives the sort-based
aggregate is made of at these shapes (60 M rows, segment ids sorted, 6 and
16384 groups).  Prints one JSON line per part and writes
``<DIR>/general_profile.json`` (``--out``, default ``_chip/``, git-ignored).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from strawboat_tpu_torch.benchsuite import tpch  # noqa: E402
from strawboat_tpu_torch.exec import DeviceColumn, DeviceTable, col, hash_aggregate  # noqa: E402
from strawboat_tpu_torch.exec import make_resident  # noqa: E402


def device_profile(fn, top: int = 12) -> dict:
    fn()  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            counts[e.name] += 1
    busy_s = sum(by_name.values()) / 1e6
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1 - busy_s / wall if wall else None,
            "top_device": [{"name": n[:120], "ms": us / 1e3, "count": counts[n]}
                           for n, us in by_name.most_common(top)]}


def primitives(n: int, device) -> dict:
    """CUDA-event times of the sort-based aggregate's building blocks at n
    rows."""
    g = torch.Generator(device=device).manual_seed(0)
    out = {}
    v = torch.randint(0, 1 << 40, (n,), dtype=torch.int64, device=device, generator=g)
    out["sort_stable_int64_ms"] = cs.event_ms(lambda: torch.sort(v, stable=True), reps=5)
    b = v < (1 << 39)
    out["sort_stable_uint8_ms"] = cs.event_ms(lambda: torch.sort(b.to(torch.uint8), stable=True), reps=5)
    idx = torch.randperm(n, device=device, generator=g)
    out["gather_int64_ms"] = cs.event_ms(lambda: v[idx], reps=5)
    out["cumsum_int64_ms"] = cs.event_ms(lambda: torch.cumsum(v, 0), reps=5)
    vf = v.double()
    for groups in (6, 16384):
        seg = torch.sort(torch.randint(0, groups, (n,), device=device, generator=g)).values
        bounds = torch.arange(groups + 1, device=device)
        off = torch.searchsorted(seg, bounds)
        facts = {"searchsorted_offsets_ms": cs.event_ms(lambda: torch.searchsorted(seg, bounds), reps=5)}
        for red in ("sum", "max"):
            facts[f"segment_reduce_{red}_float64_ms"] = cs.event_ms(
                lambda red=red: torch.segment_reduce(vf, red, offsets=off, initial=0.0), reps=5)
        out[f"groups_{groups}"] = facts
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "_chip"), help="directory for the report")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_general_profile: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rows = cs.SF10_ROWS
    results = {"nvidia_smi": cs.nvidia_smi(), "rows": rows}
    cols = tpch.generate_lineitem(1.0, seed=cs.SEED, rows=rows)
    orders = tpch.generate_orders(rows / tpch.ROWS_PER_SF, seed=1)

    def table(c, names):
        return DeviceTable({k: DeviceColumn(k, str(c[k].dtype), torch.from_numpy(c[k]).to(device))
                            for k in names}, len(c[names[0]]))

    lt = table(cols, ["l_orderkey", "l_extendedprice", "l_discount"])
    ot = table(orders, list(orders))
    rt = make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, device)

    def q3_like():
        return tpch.q3_rows(*tpch.q3_like(lt, ot))

    def q1_general():
        t, pad = rt.as_device_table(list(tpch.Q1_Q6_COLUMNS))
        mask = pad & (col("l_shipdate") <= tpch.EPOCH_DAYS - tpch.Q1_DEFAULT_DELTA).mask(t)
        res = hash_aggregate(t, ["l_returnflag", "l_linestatus"], tpch.q1_aggs(), num_groups=16, mask=mask)
        return {k: v.cpu().numpy().tolist() for k, v in res.items()}

    for part, fn in (("q3_like", q3_like), ("q1_general", q1_general)):
        results[part] = device_profile(fn)
        cs.emit("general_profile", part=part, **results[part])
    del lt, ot, rt
    torch.cuda.empty_cache()
    results["primitives"] = primitives(rows, device)
    cs.emit("general_profile", part="primitives", **results["primitives"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "general_profile.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

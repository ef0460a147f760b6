#!/usr/bin/env python
"""K9 (``kernels/keyed_add.py``) timed at the four-card Q15's shape on one card.

Makes rank 0's share of TPC-H SF100 Q15's four columns as K1 gives them
(int32 words in 287 tiles of 16,384 x 32 slots, ``--rows`` real rows):
``l_suppkey`` 1..1,000,000, ``l_extendedprice`` 24 bits (int64),
``l_discount`` 0..10 (int64) and ``l_shipdate`` as lineitem has it (1-7
lines an order, each shipped 1-121 days after its order's date), and
times the quarter's revenue by supplier (2^20 slots) through:

* ``k9``: one K9 launch (its kernel's device time from ``torch.profiler``,
  and a CUDA-event window that also holds the memset and the wrapper);
* ``k9_shared``: the same rows by discount (11 dictionary slots: K9's
  shared-memory way);
* ``k9_global_11``: the same 11 slots added in device memory (K9's other
  way, forced), so the two ways compare at one shape;
* ``plain``: K9's plain torch version on the card;
* ``torch_route``: the route K9 replaces (the quarter's compares, the
  widening, the product, ``dist_agg.dense_partials``' wheres and two
  ``index_add_``).

Each K9 result is checked against the plain version.  The bound is each
input's rows read once at 3.35 TB/s; ``needed_bytes`` counts what these
rows need of K9's reads: the ship date of every row, and of the other
three columns the 32-byte sectors that hold a kept row; K9's time is given
as a share of each.  The last line is
a JSON summary naming the card and its power limit.

    python3 scripts/torch_keyed_add_time.py --out <dir>                 # on the card
    python3 scripts/torch_keyed_add_time.py --device cpu --rows 200000  # a rehearsal
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

HBM_BYTES_PER_S = 3.35e12
SLOT_TILE = 16384 * 32  # the slots of one tile of a resident plane at tile 16,384


def _card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"device": "cpu"}
    out = {"device": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["nvidia_smi"] = None
    return out


def q15_words(rows: int, seed: int, device):
    """(l_suppkey, l_extendedprice, l_discount, l_shipdate) int32 words of
    ``rows`` real rows, padded with zeros to whole tiles."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    n = -(-rows // SLOT_TILE) * SLOT_TILE

    def ints(lo, hi, k):
        return torch.randint(lo, hi, (k,), generator=g, device=device, dtype=torch.int32)

    orders = rows // 2 + 1  # 1-7 lines each: more than enough lines, cut at rows
    lines = ints(1, 8, orders)
    order_date = torch.repeat_interleave(ints(0, 2406, orders), lines)[:rows]
    ship = order_date + ints(1, 122, rows)
    cols = [ints(1, 1_000_001, rows), ints(90_000, 1 << 24, rows), ints(0, 11, rows), ship]
    return [torch.cat([c, c.new_zeros(n - rows)]).contiguous() for c in cols]


def kernel_ms(fn, reps: int, match: str) -> float:
    """Median device ms a call of the kernels whose names hold ``match``
    (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = [e for e in prof.events() if match in e.name and e.device_type.name == "CUDA"]
    if len(per) != reps:
        raise AssertionError(f"{len(per)} {match} kernels in the trace for {reps} calls")
    return statistics.median(e.time_range.elapsed_us() / 1000.0 for e in per)


def event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=150_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--quarter", type=int, nargs=2, default=(1096, 1186))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from strawboat_tpu_torch.kernels import keyed_add as k9
    from strawboat_tpu_torch.parallel.dist_agg import dense_partials
    from strawboat_tpu_torch.util import obs

    device = torch.device(args.device)
    supp, price, disc, ship = q15_words(args.rows, args.seed, device)
    lo, hi = args.quarter
    terms = [[k9.Factor(price, True), k9.Factor(disc, True, "sub", 100)]]
    bounds = [(ship, lo, hi)]
    def k9_global_11():
        way, k9.plan_adds = k9.plan_adds, lambda slots, n_terms: "global"
        try:
            return k9.keyed_add(disc, args.rows, 11, terms, clamp=True, bounds=bounds)
        finally:
            k9.plan_adds = way

    calls = {
        "k9": lambda: k9.keyed_add(supp, args.rows, 1 << 20, terms, bounds=bounds),
        "k9_shared": lambda: k9.keyed_add(disc, args.rows, 11, terms, clamp=True, bounds=bounds),
        "k9_global_11": k9_global_11,
        "plain": lambda: k9.keyed_add_plain(supp, args.rows, 1 << 20, terms, bounds=bounds),
    }

    def torch_route():
        s = ship[: args.rows]
        m = (s >= lo) & (s < hi)
        rev = price[: args.rows].long() * (100 - disc[: args.rows].long())
        return dense_partials(supp[: args.rows], (rev,), m, 1 << 20)[0][0]

    calls["torch_route"] = torch_route
    out = {"card": _card(device), "rows": args.rows, "slots": int(supp.shape[0]),
           "quarter": [lo, hi]}
    want = calls["plain"]()
    kept = int(want[-1].sum())
    out["kept_rows"] = kept
    out["kept_share"] = kept / args.rows
    s = ship[: args.rows // 8 * 8].view(-1, 8)
    sectors = int(((s >= lo) & (s < hi)).any(1).sum())
    out["needed_bytes"] = 4 * args.rows + 3 * 32 * sectors
    for name in ("k9", "torch_route"):
        got = calls[name]()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from the plain version")
    shared_want = k9.keyed_add_plain(disc, args.rows, 11, terms, clamp=True, bounds=bounds)
    for name in ("k9_shared", "k9_global_11"):
        if not torch.equal(calls[name](), shared_want):
            raise AssertionError(f"{name} differs from the plain version")
    out["ways"] = {"k9": k9.plan_adds(1 << 20, 1), "k9_shared": k9.plan_adds(11, 1)}
    bound_bytes = 4 * 4 * args.rows
    out["bound_bytes"] = bound_bytes
    out["bound_ms"] = bound_bytes / HBM_BYTES_PER_S * 1e3
    if device.type != "cuda":
        out["times"] = "not measured (no card)"
        print(json.dumps(out))
        return 0
    before = obs.counter("k9.launches")
    times = {}
    for name in ("k9", "k9_shared", "k9_global_11"):
        times[name + "_kernel_ms"] = kernel_ms(calls[name], args.reps, "keyed_add_kernel")
    for name, fn in calls.items():
        times[name + "_event_ms"] = event_ms(fn, args.reps)
    out["times"] = times
    out["k9_share_of_bound_pct"] = out["bound_ms"] / times["k9_kernel_ms"] * 100
    out["k9_needed_gb_per_s"] = out["needed_bytes"] / times["k9_kernel_ms"] / 1e6
    out["k9_share_of_needed_pct"] = out["k9_needed_gb_per_s"] * 1e9 / HBM_BYTES_PER_S * 100
    out["k9_launches"] = obs.counter("k9.launches") - before
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "keyed_add_time.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

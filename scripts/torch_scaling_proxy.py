#!/usr/bin/env python
"""Scaling proxy of the torch port's streamed distributed aggregate
(BASELINE: rows/s from 1 to N shards).

The port's ``scripts/scaling_proxy.py``: the same config-5 pipeline as
``torch_dist_sf1_stream.py`` (12 parts → chunked decode → keyed exchange
→ final combine) at 1 and ``--shards`` N shards, each run checked exactly
against numpy (a wrong answer exits 1), each split into its feed
(``prepared_dataset_chunks``: decode and split over the mesh) and its
exchange and combine (``pipelined_distributed_aggregate`` over the fed
chunks).  Prints one JSON line with the reference's keys: ``rows_s_1``,
``rows_s_N`` (at ``n_shards``), ``speedup_N`` = rows_s_N / rows_s_1,
``efficiency_proxy`` = rows_s_N / rows_s_1 / N (the reference's
definition, read against BASELINE's 85% target) and ``n_rows``, with the
stages' seconds beside them.

In one process all shards sit on the one ``--device``: a mesh of N shards
on one card does the work of one, so ``speedup_N`` near 1 means the
sharded layer costs nothing a shard, and ``efficiency_proxy`` cannot pass
1/N; this measures the layer's cost, not scale-out.  Under ``torchrun``
each process holds its shards on its own card, the base run has one shard
a process, and the keys say so: ``rows_s_base`` at ``base_shards`` (the
world size) in place of ``rows_s_1``, and ``efficiency_proxy`` =
(rows_s_N / N) / (rows_s_base / base_shards).

    python scripts/torch_scaling_proxy.py --shards 4          # on the card
    python scripts/torch_scaling_proxy.py --device cpu --rows 50000 --shards 2
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from torch_dist_sf1_stream import (  # noqa: E402
    check,
    group_sums,
    join_world,
    numpy_sums,
    streamed,
    write_parts,
)

AGGS = {"sum_price": ("sum", "l_extendedprice"), "cnt": ("count", "l_extendedprice")}
COLUMNS = ("l_quantity", "l_extendedprice", "l_discount")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_500_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.kernels.bitunpack import launch_counts
    from strawboat_tpu_torch.parallel import make_mesh, pipelined_distributed_aggregate
    from strawboat_tpu_torch.parallel.pipeline import prepared_dataset_chunks

    device, world, rank = join_world(torch.device(args.device))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    cols = tpch.generate_lineitem(1.0, seed=args.seed, rows=args.rows)
    names = tuple(AGGS)
    want = numpy_sums(cols, names)
    n = args.rows

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    with tempfile.TemporaryDirectory(prefix="sb_scale_") as d:
        paths = write_parts(d, cols, COLUMNS, args.seed)

        def run(n_shards: int):
            """(end to end s, feed s, exchange s) at ``n_shards``, best of reps."""
            mesh = make_mesh(n_shards, device)
            e2e, feed, ex = [], [], []
            for _ in range(args.reps + 1):  # the first run builds the kernels
                t, res = timed(lambda: streamed(mesh, paths, AGGS))
                check(group_sums(res, names) == want, f"{n_shards} shards: aggregate")
                e2e.append(t)
                t, chunks = timed(lambda: list(prepared_dataset_chunks(
                    mesh, "shards", paths, "l_quantity", AGGS, chunk_pages=16)))
                feed.append(t)
                t, res = timed(lambda: pipelined_distributed_aggregate(
                    mesh, "shards", iter(chunks), num_groups=128))
                check(group_sums(res, names) == want, f"{n_shards} shards: staged aggregate")
                ex.append(t)
            return min(e2e[1:]), min(feed[1:]), min(ex[1:])

        base = world
        t1, f1, e1 = run(base)
        tn, fn, en = run(args.shards)
    tag = "1" if base == 1 else "base"
    out = {f"rows_s_{tag}": n / t1, "rows_s_N": n / tn, "n_shards": args.shards,
           "base_shards": base, "speedup_N": t1 / tn,
           "efficiency_proxy": (n / tn / args.shards) / (n / t1 / base), "n_rows": n,
           f"feed_s_{tag}": f1, "feed_s_N": fn, f"exchange_s_{tag}": e1, "exchange_s_N": en,
           "device": str(device), "rank": rank, "world": world,
           "script": "torch_scaling_proxy", **launch_counts(), "ok": True}
    print(json.dumps(out), flush=True)
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Distributed hash aggregate over the port's mesh, by shard count.

The port's ``examples/dist_bench.py``: ``distributed_aggregate`` (local
partials → keyed all_to_all → final combine) over 1, 2, 4 and 8 shards,
the same rows per shard at each count; prints rows/s and the scaling
efficiency against the first count.

In one process every shard is on ONE device, so this measures what the
layer costs per shard (the loop over shards, the exchange's copies, the
capacity reads), not scale-out.  Under ``torchrun`` (``WORLD_SIZE`` set)
the mesh spans the processes: each joins the world through
``distributed_init("env://", ...)`` (nccl on cards, gloo on the CPU),
holds its shards on its own card (``cuda:LOCAL_RANK``), runs the shard
counts the world size divides, and prints its own rows/s.

    python examples/torch_dist_bench.py --device cuda
    python examples/torch_dist_bench.py --device cpu --rows-per-shard 65536
    torchrun --nproc_per_node=4 examples/torch_dist_bench.py --device cuda
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strawboat_tpu_torch.parallel import (  # noqa: E402
    distributed_aggregate,
    distributed_init,
    make_mesh,
    shard,
)
from strawboat_tpu_torch.parallel.collectives import sum_to_host  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows-per-shard", type=int, default=1 << 22)
    ap.add_argument("--max-shards", type=int, default=8)
    ap.add_argument("--groups", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    device = torch.device(args.device)
    world, rank = int(os.environ.get("WORLD_SIZE", "1")), 0
    if "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        distributed_init("env://", world, rank, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    base = None
    for n_shards in (s for s in (1, 2, 4, 8, 16) if s <= args.max_shards and s % world == 0):
        mesh = make_mesh(n_shards, device)
        n = args.rows_per_shard * n_shards
        key_np, val_np = rng.integers(0, args.groups, n), rng.integers(0, 10**6, n)
        key = shard(mesh, "shards", torch.from_numpy(key_np))  # this process's shards
        val = shard(mesh, "shards", torch.from_numpy(val_np))

        def run():
            return distributed_aggregate(mesh, "shards", key, {"total": ("sum", val)},
                                         num_groups=2048)

        run()  # warm
        sync()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = run()
            sync()
            times.append(time.perf_counter() - t0)
        total = sum(int(t.sum()) for t in res["total"].shards)
        assert sum_to_host(total, device) == int(val_np.sum()), "distributed aggregate lost rows"
        seconds = float(np.median(times))
        rps = len(key) / seconds  # the rows this process aggregated
        base = base or rps * world / n_shards  # rows/s a shard at the first count
        print(json.dumps({"device": str(device), "rank": rank, "world": world,
                          "shards": n_shards, "rows": n, "ms": seconds * 1e3, "rows_per_s": rps,
                          "scaling_efficiency": rps * world / (n_shards * base)}), flush=True)
    if device.type == "cuda":
        print(json.dumps({"card": torch.cuda.get_device_name(device)}))
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

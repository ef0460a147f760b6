#!/usr/bin/env python
"""Distributed hash aggregate over a single-process mesh, by shard count.

The port's ``examples/dist_bench.py``: ``distributed_aggregate`` (local
partials → keyed all_to_all → final combine) over 1, 2, 4 and 8 shards,
every shard on ONE device, the same rows per shard at each count; prints
rows/s and the scaling efficiency against one shard.  The shards share
the device, so this measures what the layer costs per shard (the loop
over shards, the exchange's copies, the capacity reads), not scale-out.

    python examples/torch_dist_bench.py --device cuda
    python examples/torch_dist_bench.py --device cpu --rows-per-shard 65536
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strawboat_tpu_torch.parallel import distributed_aggregate, make_mesh  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows-per-shard", type=int, default=1 << 22)
    ap.add_argument("--max-shards", type=int, default=8)
    ap.add_argument("--groups", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    base = None
    for n_shards in (s for s in (1, 2, 4, 8, 16) if s <= args.max_shards):
        mesh = make_mesh(n_shards, device)
        n = args.rows_per_shard * n_shards
        key = torch.from_numpy(rng.integers(0, args.groups, n)).to(device)
        val = torch.from_numpy(rng.integers(0, 10**6, n)).to(device)

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
        assert total == int(val.sum()), "distributed aggregate lost rows"
        seconds = float(np.median(times))
        rps = n / seconds
        base = base or rps
        print(json.dumps({"device": str(device), "shards": n_shards, "rows": n,
                          "ms": seconds * 1e3, "rows_per_s": rps,
                          "scaling_efficiency": rps / (n_shards * base)}), flush=True)
    if device.type == "cuda":
        print(json.dumps({"card": torch.cuda.get_device_name(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""BASELINE config 5 at SF1 on the torch port: a 12-part lineitem dataset
streamed through the pipelined distributed aggregate.

The port's ``scripts/dist_sf1_stream.py``: lineitem SF1 (6 M rows,
seeded) written as 12 part files with zone maps, then
``streamed_dataset_aggregate`` (chunked decode on the card, a local
partial aggregate a shard, the keyed exchange, the final combine) over a
mesh of ``--shards`` shards, grouped by l_quantity (50 groups).  The group
totals are checked exactly against numpy; a wrong answer exits 1.  The
last line is a JSON summary.

In one process every shard sits on the one ``--device``.  Under
``torchrun`` the mesh spans the processes, one card each
(``cuda:LOCAL_RANK``; nccl on cards, gloo on the CPU): every process
writes its own copy of the parts, decodes every chunk and keeps its own
shards, and the checks read every process's groups.

    python scripts/torch_dist_sf1_stream.py --rows 1000000 --shards 4
    python scripts/torch_dist_sf1_stream.py --device cpu --rows 50000 --shards 2
    torchrun --nproc_per_node=4 scripts/torch_dist_sf1_stream.py --shards 4
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

PARTS = 12
AGGS = {"sum_price": ("sum", "l_extendedprice"), "sum_disc": ("sum", "l_discount"),
        "cnt": ("count", "l_extendedprice")}
COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"WRONG: {what}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def join_world(device):
    """(device, world size, rank): under torchrun this process joins the
    world (``env://``) on ``cuda:LOCAL_RANK`` for a card."""
    import torch

    from strawboat_tpu_torch.parallel import distributed_init

    if "WORLD_SIZE" not in os.environ:
        return device, 1, 0
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    distributed_init("env://", world, rank, device)
    return device, world, rank


def write_parts(directory: str, cols, columns, seed: int):
    """The columns as 12 part files (LZ4 pages through the adaptive
    chooser, zone maps) → their paths."""
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec.dataset import write_dataset

    n = len(cols[columns[0]])
    options = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                           max_page_size=65536, sample_seed=seed, zone_maps=True)
    return write_dataset(directory, {k: cols[k] for k in columns}, n // PARTS + 1, options=options)


def group_sums(res, names) -> dict:
    """{key: (aggregate, ...)} over every process's valid group slots."""
    from strawboat_tpu_torch.parallel.collectives import gather_objects

    mine = {}
    for s, valid in enumerate(res["valid"].shards):
        ok = valid.cpu().numpy()
        keys = res["keys"].shards[s].cpu().numpy()[ok]
        vals = [res[n].shards[s].cpu().numpy()[ok] for n in names]
        for i, k in enumerate(keys.tolist()):
            mine[int(k)] = tuple(int(v[i]) for v in vals)
    out = {}
    for part in gather_objects(mine):
        out.update(part)
    return out


def numpy_sums(cols, names) -> dict:
    qty = cols["l_quantity"]
    want = {}
    for q in np.unique(qty):
        m = qty == q
        agg = {"sum_price": int(cols["l_extendedprice"][m].sum()),
               "sum_disc": int(cols["l_discount"][m].sum()), "cnt": int(m.sum())}
        want[int(q)] = tuple(agg[n] for n in names)
    return want


def streamed(mesh, paths, aggs):
    from strawboat_tpu_torch.parallel import streamed_dataset_aggregate

    return streamed_dataset_aggregate(mesh, "shards", paths, key="l_quantity", aggs=aggs,
                                      chunk_pages=16, num_groups=128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=6_000_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.kernels.bitunpack import launch_counts
    from strawboat_tpu_torch.parallel import make_mesh

    device, world, rank = join_world(torch.device(args.device))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    cols = tpch.generate_lineitem(1.0, seed=args.seed, rows=args.rows)
    print(f"gen {args.rows} rows: {time.perf_counter() - t0:.1f}s", flush=True)
    names = tuple(AGGS)
    with tempfile.TemporaryDirectory(prefix="sb_sf1_ds_") as d:
        t0 = time.perf_counter()
        paths = write_parts(d, cols, COLUMNS, args.seed)
        print(f"wrote {len(paths)} parts: {time.perf_counter() - t0:.1f}s", flush=True)
        mesh = make_mesh(args.shards, device)
        times = []
        for _ in range(2):  # the first run builds the kernels
            t0 = time.perf_counter()
            res = streamed(mesh, paths, AGGS)
            sync()
            times.append(time.perf_counter() - t0)
        got = group_sums(res, names)
    check(got == numpy_sums(cols, names), "streamed distributed aggregate against numpy")
    t = times[-1]
    print(f"streamed distributed aggregate over {len(paths)} parts / {args.shards} shards "
          f"on {device} (rank {rank} of {world}): {t:.2f}s warm = {args.rows / t / 1e6:.2f} "
          f"Mrows/s (cold {times[0]:.2f}s), {len(got)} groups exact against numpy", flush=True)
    print(json.dumps({"script": "torch_dist_sf1_stream", "device": str(device), "rank": rank,
                      "world": world, "shards": args.shards, "rows": args.rows,
                      "parts": len(paths), "cold_s": times[0], "warm_s": t,
                      "rows_per_s": args.rows / t, "groups": len(got), **launch_counts(),
                      "ok": True}), flush=True)
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Write throughput of the torch port's ``NativeWriter`` against parquet.

The port's ``examples/bench_write.py`` (the reference's
benches/write_strawboat.rs and write_parquet.rs): int64, utf8 and bool
columns at 2^10 … 2^20 rows, LZ4 pages of 8192 rows, best of ``--iters``
writes into memory, beside ``pyarrow.parquet`` (LZ4, no dictionary).  Each
size's strawboat file is then scanned onto the device and read back on
the host, and must equal the table written; a wrong answer exits 1.  The
last line is a JSON summary.

    python examples/torch_bench_write.py                     # scans on the card
    python examples/torch_bench_write.py --device cpu --max-log2 14
"""

import argparse
import io
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


def make_table(log2_size: int, seed: int):
    import pyarrow as pa

    n = 1 << log2_size
    rng = np.random.default_rng(seed)
    return pa.table({
        "i64": pa.array(rng.integers(0, 1 << 40, n).astype(np.int64)),
        "utf8": pa.array([f"value-{i % 100}" for i in range(n)]),
        "bool": pa.array(rng.random(n) > 0.5),
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-log2", type=int, default=20)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)

    import pyarrow.parquet as pq
    import torch

    from strawboat_tpu_torch.api import read_table
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import scan_file
    from strawboat_tpu_torch.kernels.bitunpack import launch_counts
    from strawboat_tpu_torch.write.writer import NativeWriter

    device = torch.device(args.device)
    opts = WriteOptions(default_compression=Compression.LZ4, max_page_size=8192,
                        sample_seed=args.seed)

    def strawboat(table, out):
        w = NativeWriter(out, table.schema, opts)
        w.start()
        w.write(table)
        w.finish()

    def best(fn, table):
        times = []
        for _ in range(args.iters):
            buf = io.BytesIO()
            t0 = time.perf_counter()
            fn(table, buf)
            times.append(time.perf_counter() - t0)
        return min(times)

    rows = []
    print(f"{'rows':>10} {'strawboat ms':>14} {'parquet ms':>12} {'ratio':>7}", flush=True)
    with tempfile.TemporaryDirectory(prefix="sb_bench_write_") as d:
        for lg in (x for x in (10, 14, 17, 20) if x <= args.max_log2):
            table = make_table(lg, args.seed)
            ts = best(strawboat, table)
            tp = best(lambda t, buf: pq.write_table(t, buf, compression="lz4",
                                                    use_dictionary=False), table)
            print(f"{1 << lg:>10} {ts * 1e3:>14.1f} {tp * 1e3:>12.1f} {tp / ts:>7.2f}", flush=True)
            path = os.path.join(d, f"w{lg}.str")
            with open(path, "wb") as f:
                strawboat(table, f)
            check(read_table(path).equals(table), f"2^{lg} rows: read_table")
            dt = scan_file(path, device, columns=["i64", "bool"])
            check(dt["i64"].values.device.type == device.type, "scan device")
            check(np.array_equal(dt["i64"].values.cpu().numpy(), table["i64"].to_numpy())
                  and np.array_equal(dt["bool"].values.cpu().numpy(),
                                     table["bool"].to_numpy(zero_copy_only=False)),
                  f"2^{lg} rows: device scan")
            rows.append({"rows": 1 << lg, "strawboat_ms": ts * 1e3, "parquet_ms": tp * 1e3})
    print(json.dumps({"script": "torch_bench_write", "device": str(device), "sizes": rows,
                      **launch_counts(), "ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

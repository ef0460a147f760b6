#!/usr/bin/env python
"""Dataset demo of the torch port: partitioned write, pruned multi-file
scan, and a query over the glob.

  1. ``write_dataset`` splits a table into standalone part files, each with
     its own footer and zone block (the README's adaptive write options);
  2. ``scan_dataset`` skips whole parts from their footers, prunes the
     pages of the rest and concatenates them on the device;
  3. ``Query`` runs filter and group-by straight over the glob.

Every answer is checked against numpy.

    python examples/torch_dataset_demo.py                 # on the card
    python examples/torch_dataset_demo.py --device cpu --rows 60000
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=300_000)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--dir", default=None, help="where the parts go (default: a temporary directory)")
    args = ap.parse_args()

    import numpy as np

    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import Query, col, scan_dataset
    from strawboat_tpu_torch.exec.dataset import file_may_match, write_dataset
    from strawboat_tpu_torch.exec.pruning import Comparison

    n = args.rows
    rng = np.random.default_rng(0)
    ts = np.sort(rng.integers(0, 10_000, n)).astype(np.int64)
    region = np.array(["emea", "apac", "amer"])[rng.integers(0, 3, n)]
    value = rng.integers(0, 10**6, n).astype(np.int64)
    options = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                           max_page_size=8192, sample_seed=3, zone_maps=True)

    with tempfile.TemporaryDirectory(prefix="sb_dataset_", dir=args.dir) as d:
        t0 = time.perf_counter()
        paths = write_dataset(d, {"ts": ts, "region": region, "value": value},
                              rows_per_file=-(-n // args.parts), options=options)
        print(f"wrote {len(paths)} parts in {time.perf_counter() - t0:.3f} s")

        # ts is sorted, so each part holds a band of it: a narrow range
        # skips most parts from their footers
        preds = [Comparison("ts", "ge", 4000), Comparison("ts", "lt", 4500)]
        kept = [p for p in paths if file_may_match(p, preds)]
        print(f"files kept {len(kept)} of {len(paths)}")
        t0 = time.perf_counter()
        dt = scan_dataset(paths, args.device, predicates=preds)
        sel = (ts >= 4000) & (ts < 4500)
        got = dt["ts"].values.cpu().numpy()
        # pages that straddle the range stay: the exact filter runs after
        assert np.array_equal(got[(got >= 4000) & (got < 4500)], ts[sel])
        print(f"pruned scan: {dt.num_rows} rows in {time.perf_counter() - t0:.3f} s")

        res = (Query(os.path.join(d, "part-*.str"), device=args.device)
               .filter((col("ts") >= 4000) & (col("ts") < 4500))
               .group_by("region", num_groups=16)
               .agg(total=("sum", "value"), cnt=("count", "value"))
               .run())
        ng = int(res["n_groups"])
        exact = True
        for code, total, cnt in zip(res["key_region"][:ng].tolist(), res["total"][:ng].tolist(),
                                    res["cnt"][:ng].tolist()):
            name = res["dict_region"][code].decode()
            m = sel & (region == name)
            exact &= total == int(value[m].sum()) and cnt == int(m.sum())
            print(f"  {name}: total={total} cnt={cnt}")
        if not exact:
            raise SystemExit("query answers differ from numpy")
        print("query answers exact against numpy")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""TPC-H Q1/Q6 end to end on the torch port (BASELINE config 4's shape).

The port's ``examples/tpch_bench.py``: generates lineitem at the given
scale (seeded), writes it with zone maps through the adaptive chooser,
then times a cold and a warm scan onto the device, the Q6-pruned scan, Q6
over it, and Q1 over the whole scan through both the sort-based ``q1``
and the dense-code ``q1_dense``.  Every answer is checked against the
numpy references of ``benchsuite/tpch.py`` (Q1's two paths also against
each other); a wrong answer exits 1.  The last line is a JSON summary.

    python examples/torch_tpch_bench.py                      # on the card
    python examples/torch_tpch_bench.py --device cpu --rows 50000
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"WRONG: {what}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--rows", type=int, default=None, help="override the scale's row count")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import scan_file
    from strawboat_tpu_torch.kernels.bitunpack import launch_counts

    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    cols = tpch.generate_lineitem(args.scale, seed=args.seed, rows=args.rows)
    n = len(cols["l_shipdate"])
    print(f"gen lineitem sf={args.scale}: {n} rows ({time.perf_counter() - t0:.1f}s)", flush=True)
    out = {"script": "torch_tpch_bench", "device": str(device), "rows": n}
    with tempfile.TemporaryDirectory(prefix="sb_tpch_") as d:
        path = os.path.join(d, "lineitem.str")
        options = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                               max_page_size=65536, sample_seed=args.seed, zone_maps=True)
        _, t = timed(lambda: tpch.write_lineitem(path, cols, options=options))
        size = os.path.getsize(path)
        print(f"write: {t:.2f}s ({n / t / 1e6:.1f} Mrows/s, {size / 1e6:.0f} MB on disk)",
              flush=True)
        out.update(write_s=t, bytes=size)

        _, t = timed(lambda: scan_file(path, device))
        print(f"device scan (cold, incl. kernel builds): {t:.2f}s", flush=True)
        full, t = timed(lambda: scan_file(path, device))
        print(f"device scan (warm): {t:.3f}s ({n / t / 1e6:.1f} Mrows/s, "
              f"{size / t / 1e6:.0f} MB/s compressed)", flush=True)
        out.update(scan_s=t)
        pruned, t = timed(lambda: scan_file(path, device, predicates=tpch.q6_pruning_predicates()))
        print(f"device scan (Q6-pruned): {t:.3f}s ({pruned.num_rows}/{n} rows decoded)", flush=True)
        out.update(pruned_scan_s=t, pruned_rows=pruned.num_rows)

        rev, t = timed(lambda: int(tpch.q6(pruned)))
        check(rev == tpch.q6_numpy_reference(cols), f"Q6 revenue {rev}")
        print(f"Q6: {t * 1e3:.1f} ms (first), revenue={rev}", flush=True)
        _, t = timed(lambda: int(tpch.q6(pruned)))
        print(f"Q6 warm: {t * 1e3:.1f} ms", flush=True)
        out.update(q6_ms=t * 1e3)

        want = tpch.q1_numpy_reference(cols)
        res, t = timed(lambda: tpch.q1_rows(tpch.q1(full)))
        check(res == want, "Q1 (sort-based) against numpy")
        print(f"Q1: {t * 1e3:.1f} ms (first), {len(res)} groups", flush=True)
        _, t = timed(lambda: tpch.q1(full))
        print(f"Q1 warm: {t * 1e3:.1f} ms", flush=True)
        out.update(q1_ms=t * 1e3)
        dense, t = timed(lambda: tpch.q1_dense(full))
        check(tpch.q1_table_rows(dense) == res, "q1_dense against q1")
        print(f"Q1 dense: {t * 1e3:.1f} ms (first)", flush=True)
        _, t = timed(lambda: tpch.q1_dense(full))
        print(f"Q1 dense warm: {t * 1e3:.1f} ms", flush=True)
        out.update(q1_dense_ms=t * 1e3, ok=True)
    out.update(launch_counts())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

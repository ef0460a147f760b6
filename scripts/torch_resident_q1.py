#!/usr/bin/env python
"""TPC-H Q1 over a resident table on the torch port: utf8 group keys,
float64 measures, a date filter, all 8 aggregates through the Query DSL.

The port's ``scripts/resident_q1.py``: writes Q1's seven lineitem columns
(the money columns as float64, as the pola-rs PDS-H preparation casts
them) with LZ4 pages through the adaptive chooser, loads them as a
resident table on the device (``load_resident``), then runs the fused Q1
once cold, checks every group against ``q1_numpy_reference`` (float sums
and averages to rtol 1e-12, counts exactly; a wrong answer exits 1) and
times it warm.  The last line is a JSON summary.

    python scripts/torch_resident_q1.py                      # on the card
    python scripts/torch_resident_q1.py --device cpu --rows 50000
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

CUTOFF = 1095  # l_shipdate <= CUTOFF (days since 1992-01-01)


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"WRONG: {what}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import load_resident
    from strawboat_tpu_torch.kernels.bitunpack import launch_counts

    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    cols = tpch.generate_lineitem(1.0, seed=args.seed, rows=args.rows)
    delta = tpch.EPOCH_DAYS - CUTOFF
    out = {"script": "torch_resident_q1", "device": str(device), "rows": args.rows}
    with tempfile.TemporaryDirectory(prefix="sb_resident_q1_") as d:
        path = os.path.join(d, "resident_q1.str")
        tpch.write_lineitem(path, cols, columns=tpch.Q1_Q6_COLUMNS, money="float64",
                            options=WriteOptions(default_compression=Compression.LZ4,
                                                 default_compress_ratio=1.0,
                                                 max_page_size=65536, sample_seed=args.seed))
        t0 = time.perf_counter()
        rt = load_resident(path, device)
        sync()
        out["load_s"] = time.perf_counter() - t0
        packed = sum(w.numel() * 4 for c in rt.columns.values() for w, _b in c.planes)
        print(f"load: {out['load_s']:.2f}s; {packed / 1e6:.1f} MB packed", flush=True)
        kinds = {k: (c.kind, [b for _w, b in c.planes], c.is_dict) for k, c in rt.columns.items()}
        print(f"columns: {kinds}", flush=True)

        def q1():
            res = tpch.q1(rt, delta, money="float64")
            sync()
            return res

        t0 = time.perf_counter()
        got = tpch.q1_rows(q1())
        print(f"Q1 first: {time.perf_counter() - t0:.2f}s", flush=True)
        want = tpch.q1_numpy_reference(cols, delta, money="float64")
        check(got.keys() == want.keys(), f"groups {sorted(got)} vs {sorted(want)}")
        for key, aggs in want.items():
            for name, w in aggs.items():
                g = got[key][name]
                ok = g == w if name == "count_order" else abs(g - w) <= 1e-12 * max(abs(w), 1)
                check(ok, f"{key} {name}: {g} vs {w}")
        print(f"Q1 against numpy: {len(got)} groups", flush=True)
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            q1()
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(f"warm resident Q1 (8 aggregates, utf8 keys, float64 measures): best "
              f"{best * 1e3:.1f} ms, median {float(np.median(times)) * 1e3:.1f} ms "
              f"({args.rows / best / 1e6:.1f} Mrows/s)", flush=True)
        out.update(q1_ms=float(np.median(times)) * 1e3, packed_bytes=packed, ok=True)
    out.update(launch_counts())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

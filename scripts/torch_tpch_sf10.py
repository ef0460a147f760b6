#!/usr/bin/env python
"""TPC-H lineitem at SF10 on the torch port (BASELINE config 4: a
multi-column scan, predicate filter and zone-map pruning, one host).

The port's ``scripts/tpch_sf10.py``: writes the 60 M-row lineitem once
(all ten columns, zone maps, the adaptive chooser), then times the host
read (``read_table``), the scan of Q6's columns onto the device plus Q6
with and without pruning, warm ``q1_dense`` and Q6 over the whole scan,
``load_resident`` of Q1's columns with warm resident Q1 and Q6, and the
device-direct ``make_resident`` of a scan.  Q6 is checked against numpy
on every run, Q1 (both paths) against the numpy reference; a wrong answer
exits 1.  The last line is a JSON summary.

    python scripts/torch_tpch_sf10.py                        # on the card
    python scripts/torch_tpch_sf10.py --device cpu --rows 50000
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


def _med(xs):
    return sorted(xs)[len(xs) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=60_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from strawboat_tpu_torch.api import read_table
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import load_resident, make_resident, scan_file
    from strawboat_tpu_torch.kernels.bitunpack import launch_counts

    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    def reps(fn, k=args.reps):
        return [timed(fn)[0] for _ in range(k)]

    n = args.rows
    t, cols = timed(lambda: tpch.generate_lineitem(10.0, seed=args.seed, rows=n))
    print(f"gen: {t:.1f}s ({n} rows)", flush=True)
    out = {"script": "torch_tpch_sf10", "device": str(device), "rows": n}
    q6_want = tpch.q6_numpy_reference(cols)
    q1_want = tpch.q1_numpy_reference(cols)
    with tempfile.TemporaryDirectory(prefix="sb_sf10_") as d:
        path = os.path.join(d, "lineitem_sf10.str")
        options = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                               max_page_size=65536, sample_seed=3, zone_maps=True)
        t, _ = timed(lambda: tpch.write_lineitem(path, cols, options=options))
        size = os.path.getsize(path)
        print(f"write: {t:.1f}s = {n / t / 1e6:.1f} Mrows/s, {size / 1e6:.0f} MB on disk",
              flush=True)
        out.update(write_s=t, bytes=size)

        q6_cols = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]

        def scan_q6(preds):
            rev = int(tpch.q6(scan_file(path, device, columns=q6_cols, predicates=preds)))
            check(rev == q6_want, f"Q6 revenue {rev} vs {q6_want}")

        preds = tpch.q6_pruning_predicates()
        scan_q6(None)
        scan_q6(preds)  # the kernels built, the file in the page cache
        full, pruned = reps(lambda: scan_q6(None)), reps(lambda: scan_q6(preds))
        print(f"scan+Q6 full: best {min(full):.3f}s = {n / min(full) / 1e6:.1f} Mrows/s, "
              f"median {_med(full):.3f}s", flush=True)
        print(f"scan+Q6 pruned: best {min(pruned):.3f}s, median {_med(pruned):.3f}s "
              f"(speedup best {min(full) / min(pruned):.2f}x)", flush=True)
        out.update(scan_q6_s=_med(full), scan_q6_pruned_s=_med(pruned))

        host = reps(lambda: read_table(path))
        print(f"host read_table: best {min(host):.2f}s = {n / min(host) / 1e6:.1f} Mrows/s, "
              f"median {_med(host):.2f}s", flush=True)
        out["read_table_s"] = _med(host)

        dt = scan_file(path, device)
        check(tpch.q1_table_rows(tpch.q1_dense(dt)) == q1_want, "q1_dense against numpy")
        check(int(tpch.q6(dt)) == q6_want, "Q6 over the whole scan")
        q1 = reps(lambda: tpch.q1_dense(dt))
        q6 = reps(lambda: int(tpch.q6(dt)))
        print(f"Q1 dense warm (scanned table): best {min(q1) * 1e3:.1f} ms, "
              f"median {_med(q1) * 1e3:.1f} ms", flush=True)
        print(f"Q6 warm (scanned table): best {min(q6) * 1e3:.1f} ms, "
              f"median {_med(q6) * 1e3:.1f} ms", flush=True)
        out.update(q1_dense_ms=_med(q1) * 1e3, q6_ms=_med(q6) * 1e3)
        del dt

        t, rt = timed(lambda: load_resident(path, device, columns=list(tpch.Q1_Q6_COLUMNS)))
        packed = sum(w.numel() * 4 for c in rt.columns.values() for w, _b in c.planes)
        print(f"resident load: {t:.1f}s; {packed / 1e6:.0f} MB packed "
              f"(against {n * 7 * 8 / 1e9:.1f} GB decoded int64)", flush=True)
        out.update(load_s=t, packed_bytes=packed)
        check(tpch.q1_rows(tpch.q1(rt)) == q1_want, "resident Q1 against numpy")
        check(int(tpch.q6(rt)) == q6_want, "resident Q6 against numpy")
        rq1, rq6 = reps(lambda: tpch.q1(rt), 5), reps(lambda: int(tpch.q6(rt)), 5)
        print(f"resident Q1 warm (fused, 8 aggregates, utf8 keys): best {min(rq1) * 1e3:.1f} ms, "
              f"median {_med(rq1) * 1e3:.1f} ms = {n / min(rq1) / 1e6:.0f} Mrows/s", flush=True)
        print(f"resident Q6 warm: best {min(rq6) * 1e3:.1f} ms, median {_med(rq6) * 1e3:.1f} ms "
              f"= {n / min(rq6) / 1e6:.0f} Mrows/s", flush=True)
        out.update(resident_q1_ms=_med(rq1) * 1e3, resident_q6_ms=_med(rq6) * 1e3)
        del rt

        dt2 = scan_file(path, device, columns=list(tpch.Q1_Q6_COLUMNS))
        t_cold, rt2 = timed(lambda: make_resident(dt2, device))
        check(int(tpch.q6(rt2)) == q6_want, "Q6 over make_resident(scan)")
        direct = reps(lambda: make_resident(dt2, device), 2)
        print(f"make_resident(DeviceTable) device-direct: warm best {min(direct):.2f}s "
              f"(cold {t_cold:.2f}s)", flush=True)
        out.update(make_resident_s=min(direct), ok=True)
    out.update(launch_counts())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

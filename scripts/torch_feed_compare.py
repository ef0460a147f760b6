"""Scan one file with two checkouts of the port, in turns, on one card.

    python3 scripts/torch_feed_compare.py --parent DIR [--rows N] [--reps K] [--out DIR]

Writes the ten TPC-H lineitem columns (seed 0, pages of 65536 rows, zone
maps) under no flag, so every page is raw: the seven integer columns and
the three utf8 ones as NONE pages.  Then scans the file whole with the
checkout at ``--parent`` and with this one, in the order parent, this,
this, parent, each run a fresh process that imports only its checkout's
``strawboat_tpu_torch``: one warm-up scan, ``--reps`` timed scans (host
clock around ``scan_file`` and a synchronize) and one scan under
``torch.profiler`` (device busy time as the union of the CUDA events,
idle share against the scan's wall time).  Prints one JSON line per run,
then the two medians over all timed scans, the idle shares, this
checkout's page-locked arena bytes, peak device memory and the card's
``nvidia-smi`` line; writes ``<DIR>/feed_compare.json`` (default
``_chip/``).  Make the parent with ``git archive <commit> | tar -x -C
DIR``; both checkouts build their own native library.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import json, statistics, sys, time
import torch
from strawboat_tpu_torch.exec import scan_file
path, reps = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)

def scan():
    t0 = time.perf_counter()
    table = scan_file(path, dev)
    torch.cuda.synchronize()
    return table, time.perf_counter() - t0

scan()  # warm-up: builds, page cache, pools
times = [scan()[1] for _ in range(reps)]
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
torch.cuda.reset_peak_memory_stats()
with torch.profiler.profile(activities=acts) as prof:
    _t, wall = scan()
spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
busy, end = 0, None
for a, b in spans:  # the union of the device intervals (copies overlap kernels)
    if end is None or a > end:
        busy, end = busy + (b - a), b
    elif b > end:
        busy, end = busy + (b - end), b
try:
    from strawboat_tpu_torch.exec import arena
    arena_bytes = arena.pooled_bytes()
except ImportError:
    arena_bytes = None
print(json.dumps({"scan_s": times, "median_s": statistics.median(times), "profiled_wall_s": wall,
                  "device_busy_s": busy / 1e6, "device_idle_share": 1 - busy / 1e6 / wall,
                  "pinned_arena_bytes": arena_bytes,
                  "max_memory_allocated": torch.cuda.max_memory_allocated()}))
"""


def run(tree: str, path: str, reps: int) -> dict:
    env = {**os.environ, "PYTHONPATH": tree}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", RUN, path, str(reps)], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        raise RuntimeError(f"scan run in {tree} failed:\n{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["process_s"] = time.perf_counter() - t0
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a checkout of the parent commit")
    ap.add_argument("--rows", type=int, default=60_000_000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "_chip"), help="directory for the report")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_feed_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from strawboat_tpu_torch.benchsuite import tpch

    parent = os.path.abspath(args.parent)
    report = {"nvidia_smi": cs.nvidia_smi(), "rows": args.rows, "reps": args.reps,
              "parent": parent, "runs": []}
    with tempfile.TemporaryDirectory() as tmpdir:
        path = os.path.join(tmpdir, "lineitem_no_flag.str")
        cols = tpch.generate_lineitem(1.0, seed=cs.SEED, rows=args.rows)
        with cs.forcing({}):
            t0 = time.perf_counter()
            tpch.write_lineitem(path, cols, max_page_size=cs.PAGE_ROWS, zone_maps=True)
        report.update(write_s=time.perf_counter() - t0, bytes=os.path.getsize(path))
        del cols
        for name, tree in (("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)):
            res = {"tree": name, **run(tree, path, args.reps)}
            report["runs"].append(res)
            cs.emit("feed_run", **res)
    for name in ("parent", "change"):
        runs = [r for r in report["runs"] if r["tree"] == name]
        report[name] = {"median_s": statistics.median(t for r in runs for t in r["scan_s"]),
                        "device_idle_share": [r["device_idle_share"] for r in runs],
                        "pinned_arena_bytes": runs[-1]["pinned_arena_bytes"],
                        "max_memory_allocated": max(r["max_memory_allocated"] for r in runs)}
    cs.emit("feed_compare", file_bytes=report["bytes"], write_s=report["write_s"],
            parent=report["parent"], change=report["change"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "feed_compare.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(report["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

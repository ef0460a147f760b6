"""Where a warm ``scan_file`` of each SF10 file spends its time, on one card.

    python3 scripts/torch_scan_profile.py [--rows N] [--out DIR]

Writes the files of ``chip_smoke.py`` (``dict`` and ``bitpack``, the seven
integer columns; ``full``, the ten lineitem columns under the ``dict``
flags with zone maps), scans each once to warm up, then once under
``cProfile`` (host: the functions with the most own time) and once under
``torch.profiler`` (device: busy time as the sum of the CUDA events, idle
share against the scan's wall time, the largest device entries by name);
``full_q6_pruned`` is Q6's four columns of the full file, pruned by
``q6_pruning_predicates``.  Prints one JSON line per scan and writes
``<DIR>/scan_profile.json`` (``--out``, default ``_chip/`` in the
checkout, git-ignored).
"""

from __future__ import annotations

import argparse
import cProfile
import collections
import json
import os
import pstats
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from strawboat_tpu_torch import native  # noqa: E402
from strawboat_tpu_torch.benchsuite import tpch  # noqa: E402
from strawboat_tpu_torch.exec import scan_file  # noqa: E402


def host_profile(path, device, top: int = 12, **scan):
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    scan_file(path, device=device, **scan)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:top]
    return wall, [{"function": f"{os.path.relpath(f[0], ROOT) if f[0].startswith(ROOT) else f[0]}:{f[1]}({f[2]})",
                   "tottime_s": v[2], "cumtime_s": v[3], "calls": v[1]} for f, v in rows]


def device_profile(path, device, top: int = 8, **scan):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        scan_file(path, device=device, **scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            counts[e.name] += 1
    busy_s = sum(by_name.values()) / 1e6
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1 - busy_s / wall if wall else None,
            "top_device": [{"name": n, "ms": us / 1e3, "count": counts[n]}
                           for n, us in by_name.most_common(top)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=cs.SF10_ROWS)
    ap.add_argument("--out", default=os.path.join(ROOT, "_chip"), help="directory for the report")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scan_profile: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    results = {"nvidia_smi": cs.nvidia_smi(), "rows": args.rows,
               "native_available": native.available(), "native_error": native.load_error(),
               "files": {}}
    cols = tpch.generate_lineitem(1.0, seed=cs.SEED, rows=args.rows)
    q6 = {"columns": ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice"),
          "predicates": tpch.q6_pruning_predicates()}
    files = [(name, flags, tpch.INT_COLUMNS, False) for name, flags in cs.FILES.items()]
    files.append(("full", cs.FILES["dict"], tpch.LINEITEM_COLUMNS, True))
    with tempfile.TemporaryDirectory() as tmpdir:
        for name, flags, columns, zone_maps in files:
            path = os.path.join(tmpdir, f"lineitem_{name}.str")
            with cs.forcing(flags):
                t0 = time.perf_counter()
                tpch.write_lineitem(path, cols, max_page_size=cs.PAGE_ROWS, columns=columns,
                                    zone_maps=zone_maps)
                write_s = time.perf_counter() - t0
            scans = {name: {}}
            if name == "full":
                scans["full_q6_pruned"] = q6
            for scan_name, scan in scans.items():
                scan_file(path, device=device, **scan)  # warm-up
                torch.cuda.synchronize()
                host_wall, host_top = host_profile(path, device, **scan)
                facts = {"write_s": write_s, "bytes": os.path.getsize(path),
                         "cprofile_wall_s": host_wall, "host_top": host_top,
                         **device_profile(path, device, **scan)}
                results["files"][scan_name] = facts
                cs.emit("scan_profile", file=scan_name,
                        native_available=results["native_available"], **facts)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "scan_profile.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

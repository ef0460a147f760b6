"""Where the adaptive write spends its host time, on one card.

    python3 scripts/torch_write_profile.py [--rows N] [--out DIR]

Writes the ten lineitem columns with the JAX benchmark's write options
(LZ4, ``default_compress_ratio=1.0``, ``sample_seed=3``, pages of 65 536
rows, zone maps) twice: once as ``write_file`` runs it (a page per thread)
for the wall time, once on one thread under ``cProfile``, whose cumulative
times split the host work into the page stats (``gen_stats``), the trial
encodes of the sampled pages (``compress_sample_ratio``), the byte codec
(LZ4 through the native library), the structured encoders and the rest.
Then the file is scanned onto the card, ordered by l_suppkey there and
written through ``write_device_table`` under ``cProfile``: the stats
reductions on the card against the host encode.  Prints one JSON line per
write and writes ``<DIR>/write_profile.json`` (``--out``, default
``_chip/`` in the checkout, git-ignored).
"""

from __future__ import annotations

import argparse
import cProfile
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
from strawboat_tpu_torch.benchsuite import tpch  # noqa: E402
from strawboat_tpu_torch.codecs import WriteOptions  # noqa: E402
from strawboat_tpu_torch.constants import Compression  # noqa: E402
from strawboat_tpu_torch.exec import scan_file  # noqa: E402
from strawboat_tpu_torch.exec.scan import DeviceColumn, DeviceTable  # noqa: E402
from strawboat_tpu_torch.write import device as device_writer  # noqa: E402
from strawboat_tpu_torch.write import writer  # noqa: E402

# the host work's parts: (name, module path suffix, function), by cumulative time
PARTS = (
    ("stats", "codecs/_family.py", "gen_stats"),
    ("trial_encodes", "codecs/_family.py", "compress_sample_ratio"),
    ("byte_codec", "native/__init__.py", "compress_batch"),
    ("integer_encoders", "codecs/integer.py", "_codec_compress"),
    ("binary_stats", "codecs/binary.py", "gen_stats"),
    ("zones", "exec/pruning.py", "compute_zones"),
    ("device_stats", "kernels/encode.py", "paged_stats_device"),
    ("device_bool_stats", "kernels/encode.py", "paged_bool_stats_device"),
    ("numeric_pages", "write/device.py", "_numeric_pages"),
    ("string_dict_pages", "write/device.py", "_string_dict_page"),
)


def profiled(fn):
    """(wall s, {part: cumulative s}, the functions of most own time)."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    parts = {}
    for name, suffix, func in PARTS:
        # a recursive function (an index subpage is a page of its own) counts
        # once, at its outermost calls: cProfile's cumulative time does that
        cum = sum(v[3] for f, v in stats.items() if f[0].endswith(suffix) and f[2] == func)
        if cum:
            parts[name] = cum
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    return wall, parts, [{"function": f"{os.path.relpath(f[0], ROOT) if f[0].startswith(ROOT) else f[0]}"
                          f":{f[1]}({f[2]})", "tottime_s": v[2], "calls": v[1]} for f, v in top]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=cs.SF10_ROWS)
    ap.add_argument("--out", default=os.path.join(ROOT, "_chip"), help="directory for the report")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_write_profile: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    results = {"nvidia_smi": cs.nvidia_smi(), "rows": args.rows, "cpus": os.cpu_count()}
    cols = tpch.generate_lineitem(1.0, seed=cs.SEED, rows=args.rows)
    opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                        max_page_size=cs.PAGE_ROWS, sample_seed=3, zone_maps=True)
    with tempfile.TemporaryDirectory() as tmpdir:
        path = os.path.join(tmpdir, "lineitem_adaptive.str")
        path2 = os.path.join(tmpdir, "lineitem_device.str")
        t0 = time.perf_counter()
        tpch.write_lineitem(path, cols, options=opts)
        threaded_s = time.perf_counter() - t0
        cpu_count = writer.os.cpu_count
        writer.os.cpu_count = lambda: 1  # one thread, so that cProfile sees every page
        try:
            wall, parts, top = profiled(lambda: tpch.write_lineitem(path, cols, options=opts))
        finally:
            writer.os.cpu_count = cpu_count
        results["write_file"] = {"threaded_s": threaded_s, "one_thread_cprofile_s": wall,
                                 "bytes": os.path.getsize(path), "parts_s": parts, "host_top": top}
        cs.emit("write_profile", what="write_file", **results["write_file"])

        table = scan_file(path, device)
        order = torch.argsort(table["l_suppkey"].values, stable=True)
        ordered = DeviceTable({k: DeviceColumn(k, c.dtype, c.values[order], None, c.dictionary)
                               for k, c in table.columns.items()}, table.num_rows)
        del table, order
        device_writer.write_device_table(path2, ordered, opts)  # warm-up
        wall, parts, top = profiled(lambda: device_writer.write_device_table(path2, ordered, opts))
        results["write_device_table"] = {"cprofile_s": wall, "bytes": os.path.getsize(path2),
                                         "parts_s": parts, "host_top": top}
        cs.emit("write_profile", what="write_device_table", **results["write_device_table"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "write_profile.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

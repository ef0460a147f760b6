"""Helpers of the benchmark's tests: tiny sizes of each cell and a run
of one on the CPU."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# tiny sizes of each cell for runs on the CPU: 60 slices of 800 orders (some
# 192,000 rows) for the resident table, of 5,000 (some 20,000 rows) for
# ingest, pages of 8192 rows, a text pool of 1 MiB
_WRITE = {"default_compression": "LZ4", "default_compress_ratio": 1.0,
          "max_page_size": 8192, "sample_seed": 3, "zone_maps": True}
TINY = {
    "resident_q1": {"config": {"orders": 48_000, "orders_per_slice": 800}},
    "resident_q6": {"config": {"orders": 48_000, "orders_per_slice": 800}},
    "file_ingest_1m": {"config": {"orders_per_slice": 5000, "text_pool_bytes": 1 << 20,
                                  "write": _WRITE},
                       "traffic": {"params": {"slice": {"range": [0, 9]}}}},
}


def tiny_run(cell, seed=2**31 + 11, trace=0, seconds=0.5, device="cpu", root=ROOT, overrides=None):
    """One run of ``cell`` at its tiny size on ``device``: the result's dict."""
    import io
    import time

    from benchmark import run

    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.run_cell(args, device_name=device, overrides=overrides or TINY[cell],
                        t_start=time.perf_counter(), log=io.StringIO(), root=root)

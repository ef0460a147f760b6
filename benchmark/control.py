#!/usr/bin/env python3
"""The control of a cell's correctness check: the reference computed one
integer precision lower (int32 for the int64 the configuration states),
put in the program's place, must come out as not correct; for ingest, a
write acknowledged before its last page is written.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--ops N]

For each seed it builds the cell's data at the cell's size, judges the
control's answers to the first ``--ops`` operations of the window's order
(default: the traffic's ``control_ops``) and prints each number beside its
limit, and whether the control failed as it must.  The benchmark's runs do
not run it.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import manifest as mf  # noqa: E402
from benchmark.lib import traffic as traffic_lib  # noqa: E402


def control_numbers(cell_name, seed, ops=None, device_name=None, overrides=None, root=ROOT):
    """The control's numbers for one seed: {name: value}, and the limits."""
    import torch

    overrides = overrides or {}
    manifest = mf.load(root)
    cell = mf.by_name(manifest["workloads"], cell_name, "workload")
    cfg = dict(mf.config_data(manifest, cell["config"], root), **overrides.get("config", {}))
    traffic = dict(mf.traffic_data(cell["traffic"], root), **overrides.get("traffic", {}))
    device = torch.device(device_name or "cuda")
    op = mf.plugin("ops", traffic["operation"], root)
    setup = mf.plugin("setups", cfg["setup"], root)
    n = int(ops or traffic["control_ops"])
    stream = traffic_lib.stream(traffic, seed)
    params = [next(stream) for _ in range(n)]
    with tempfile.TemporaryDirectory(prefix="bench_control_") as workdir:
        data = setup.build(dict(cfg, storage="host"), seed, device)
        numbers = op.control(data, cfg, traffic, params, device, workdir)
    return numbers, op.LIMITS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--ops", type=int, default=None)
    args = ap.parse_args(argv)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers, limits = control_numbers(args.workload, seed, args.ops)
        fails = any(numbers[k] > limits[k] for k in limits)
        failed_all &= fails
        print(json.dumps({"workload": args.workload, "seed": seed, "control_fails": fails,
                          "seconds": round(time.perf_counter() - t, 3),
                          "checks": {k: {"value": numbers[k], "limit": limits[k]}
                                     for k in limits}}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())

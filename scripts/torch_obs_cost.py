#!/usr/bin/env python
"""What the recorder (``util/obs.py``) costs resident Q6 and Q1, off and on.

Builds the Q1/Q6 columns of a generated lineitem table resident on the
device, warms both queries, then runs them in blocks of ``--reps``
queries with the recorder off and on in turns (off, on, on, off,
``--rounds`` times): per query the host's milliseconds (the call through
its answer on the host: Q6's ``int()``, Q1's rows) and the device's
milliseconds between CUDA events recorded before and after it.  With the
recorder on the script also reads each query's ``decode`` and
``aggregate`` spans' device milliseconds, and it times one span off and
on alone.  Medians by query and mode; the last line is a JSON summary
naming the card and its power limit.

    python3 scripts/torch_obs_cost.py --out chiprun_out           # on the card
    python3 scripts/torch_obs_cost.py --device cpu --rows 200000  # a rehearsal
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import timeit

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"device": "cpu"}
    out = {"device": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["nvidia_smi"] = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=60_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import make_resident
    from strawboat_tpu_torch.util import obs

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("torch_obs_cost: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cols = tpch.generate_lineitem(1.0, seed=args.seed, rows=args.rows)
    rt = make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, device)
    del cols
    setup_s = time.perf_counter() - t0
    queries = {"q6": lambda: int(tpch.q6(rt)), "q1": lambda: tpch.q1_rows(tpch.q1(rt))}
    want = {name: run() for name, run in queries.items()}
    for run in queries.values():
        for _ in range(5):
            run()

    def one(run):
        """(host ms, device ms) of one query."""
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            a.record()
        t = time.perf_counter()
        got = run()
        host = (time.perf_counter() - t) * 1e3
        if cuda:
            b.record()
            b.synchronize()
            return got, host, a.elapsed_time(b)
        return got, host, None

    ms = {(q, mode): {"host": [], "device": []} for q in queries for mode in ("off", "on")}
    phases = {q: {"decode": [], "aggregate": []} for q in queries}
    order = ["off", "on", "on", "off"] * args.rounds
    for mode in order:
        for q, run in queries.items():
            with obs.recording() if mode == "on" else contextlib.nullcontext() as r:
                for _ in range(args.reps):
                    got, host, dev = one(run)
                    if got != want[q]:
                        print(f"WRONG: {q} with the recorder {mode}", file=sys.stderr)
                        return 1
                    ms[(q, mode)]["host"].append(host)
                    if dev is not None:
                        ms[(q, mode)]["device"].append(dev)
            if r is not None:
                for root in r.roots:
                    for s in root.children:
                        phase = s.name.rsplit(".", 1)[1]
                        if phase in phases[q] and s.device_ms is not None:
                            phases[q][phase].append(s.device_ms)

    def med(v):
        return statistics.median(v) if v else None

    def span_off():
        with obs.span("strawboat.cost"):
            pass

    n = 100_000
    off_ns = timeit.timeit(span_off, number=n) / n * 1e9
    with obs.recording():
        on_us = timeit.timeit(span_off, number=n // 10) / (n // 10) * 1e6
    out = {"script": "torch_obs_cost", **_card(device), "rows": args.rows, "reps": args.reps,
           "order": order, "setup_s": setup_s, "span_off_ns": off_ns, "span_on_us": on_us}
    for (q, mode), v in ms.items():
        out[f"{q}_{mode}_host_ms"] = med(v["host"])
        out[f"{q}_{mode}_device_ms"] = med(v["device"])
    for q, v in phases.items():
        for phase, xs in v.items():
            out[f"{q}_{phase}_device_ms"] = med(xs)
    line = json.dumps(out)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "obs_cost.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``configs``; its file names the set-up,
``benchmark/setups/<setup>.py``) under a traffic mix
(``benchmark/traffic/<mix>.json``, whose ``operation`` names
``benchmark/ops/<operation>.py``).  Every metric is read by
``benchmark/metrics/<name>.py``.  A new cell, mix or metric is new files
and new entries; nothing here names one.

A run builds the cell's state from ``--seed`` (set-up, with a warm-up of
the operations), then runs one client in a closed loop for ``--seconds``:
it sends the next operation once the last one has answered, and the one
in flight when the time is up finishes and counts.  With ``--trace 1`` a
stretch of further operations runs under ``torch.profiler`` after the
window.  Then the program's state is freed and every answer of the window
is judged against the plain reference under ``benchmark/reference/``.
The last line of standard output is one JSON object; the last lines of
standard error are the numbers compared, each beside its limit.

An operation module has ``prepare(data, cfg, traffic, device, workdir)``
→ state, ``run(state, params)`` → the answer on the host, ``facts(state,
params)`` → what metric readers read of the program (plane shapes, pages
kept), ``check(data, traffic, done, device)`` → the numbers compared,
``LIMITS``, ``control(data, cfg, traffic, params, device, workdir)`` (run
by ``benchmark/control.py`` only) and optionally ``after_trace(state,
answers)``.  A set-up module has
``build(cfg, seed, device)`` → data with ``release()``.  A metric module
has ``read(ctx)`` → a number or None.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import manifest as mf  # noqa: E402
from benchmark.lib import trace as trace_lib  # noqa: E402
from benchmark.lib import traffic as traffic_lib  # noqa: E402

# fixed cache directories inside the checkout: only a checkout's first run
# builds or compiles (the port's nvcc and g++ builds go to its own
# ``kernels/build`` and ``native/build``)
CACHE = os.path.join(ROOT, ".bench_cache")
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda",
             "TORCH_EXTENSIONS_DIR": "torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "strawboat_tpu")
PROGRAM = "strawboat_tpu_torch"
TRACE_SPAN = "benchmark_traced_stretch"
# idle launches before the traced span: late in a process a profiler
# session records kernels only some milliseconds after it starts
LEAD_IN_S = 0.05


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must not be negative")
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    return args


def _merge(base: dict, over) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _card(device):
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu"}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device)}


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced(op, state, params, device, workdir):
    """Run ``params`` (and the op's ``after_trace``) under the profiler;
    the Chrome trace's reading (``lib/trace.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    _sync(device)
    answers = []
    with profile(activities=acts) as prof:
        if cuda:
            lead = torch.zeros(1, device=device)
            end = time.perf_counter() + LEAD_IN_S
            while time.perf_counter() < end:
                lead.add_(1)
                torch.cuda.synchronize(device)
        with record_function(TRACE_SPAN):
            for p in params:
                answers.append(op.run(state, p))
            if hasattr(op, "after_trace"):
                op.after_trace(state, answers)
            _sync(device)
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return trace_lib.read(path, TRACE_SPAN, device.type)
    finally:
        os.unlink(path)


def run_cell(args, *, device_name=None, overrides=None, t_start=None, log=sys.stderr,
             root=ROOT):
    """One run of ``args.workload``: the result's dict, or None where the
    run may print no result (no card, a forbidden module).  ``device_name``
    other than None skips the look for a card and runs there (tests);
    ``overrides`` ({"config": {...}, "traffic": {...}}) replace keys of
    the cell's files (tests run tiny sizes so); ``root`` is where
    ``BENCHMARK.json`` and the plug-in files are read."""
    t_start = T0 if t_start is None else t_start
    overrides = overrides or {}
    manifest = mf.load(root)
    cell = mf.by_name(manifest["workloads"], args.workload, "workload")
    cfg = _merge(mf.config_data(manifest, cell["config"], root), overrides.get("config"))
    traffic = _merge(mf.traffic_data(cell["traffic"], root), overrides.get("traffic"))
    for k, v in CACHE_ENV.items():
        os.environ[k] = os.path.join(CACHE, v)

    import torch

    if device_name is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"no result: {args.workload} needs {cell['chips']} CUDA device(s); "
                  f"available {torch.cuda.is_available()}, count "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=log)
            return None
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        import strawboat_tpu_torch

        where = os.path.dirname(os.path.dirname(os.path.abspath(strawboat_tpu_torch.__file__)))
        if where != ROOT:
            raise RuntimeError(f"{PROGRAM} loaded from {where}, not from this checkout {ROOT}")
    else:
        device = torch.device(device_name)

    setup = mf.plugin("setups", cfg["setup"], root)
    op = mf.plugin("ops", traffic["operation"], root)
    workdir = tempfile.mkdtemp(prefix="bench_")
    try:
        data = setup.build(cfg, args.seed, device)
        parts = dict(data.seconds)
        t = time.perf_counter()
        state = op.prepare(data, cfg, traffic, device, workdir)
        parts["prepare"] = time.perf_counter() - t
        t = time.perf_counter()
        warm = traffic_lib.stream(traffic, args.seed, purpose=1)
        warm_answers = [op.run(state, next(warm)) for _ in range(int(traffic["warm_ops"]))]
        if hasattr(op, "after_trace"):
            op.after_trace(state, warm_answers)
        _sync(device)
        parts["warm_up"] = time.perf_counter() - t
        print("set-up by part (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
              file=log)
        setup_s = time.perf_counter() - t_start

        stream = traffic_lib.stream(traffic, args.seed)
        done, attempted, failed = [], 0, 0
        w0 = time.perf_counter()
        while True:
            p = next(stream)
            attempted += 1
            try:
                done.append((p, op.run(state, p)))
            except Exception:  # an operation that fails is counted, not fatal
                failed += 1
                if failed == 1:
                    traceback.print_exc(file=log)
            if time.perf_counter() - w0 >= args.seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - w0

        tr, stretch = None, 0
        if args.trace:
            stretch = int(traffic["trace_ops"])
            params = [next(stream) for _ in range(stretch)]
            tr = _traced(op, state, params, device, workdir)
            if tr.lost_kernels:
                print(f"traced stretch lost {tr.lost_kernels} kernels; retaken once", file=log)
                tr = _traced(op, state, [next(stream) for _ in range(stretch)], device, workdir)
        peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
        facts = op.facts(state, [p for p, _a in done])
        ctx = SimpleNamespace(cell=args.workload, setup_s=setup_s, window_s=window_s, done=done,
                              trace=tr, stretch_ops=stretch, facts=facts)
        metrics = {}
        for m in mf.cell_metrics(manifest, args.workload, bool(args.trace)):
            v = mf.plugin("metrics", m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

        data.release()
        del state
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        numbers = op.check(data, traffic, done, device)
        print(f"check of {len(done)} answers: {time.perf_counter() - t:.3f} s", file=log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    bad = forbidden_modules()
    if bad:
        print(f"no result: loaded {', '.join(bad)}", file=log)
        return None
    limits = op.LIMITS
    correct = (failed == 0 and bool(done)
               and all(numbers[k] <= limits[k] for k in limits))
    dev = dict(_card(device), count=int(cell["chips"]), memory_peak_bytes=peak)
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(10), "idle_gaps": tr.idle_gaps(10)}
    result["card"] = _power_limit() if device.type == "cuda" else None
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k in limits:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=log)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    result = run_cell(args)
    if result is None:
        return 1
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

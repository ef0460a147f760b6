"""Time builds of kernel K6 against each other on one CUDA card, in turns.

    python3 scripts/torch_k6_variants.py --kernel tree=strawboat_tpu_torch/kernels/csrc/group_agg.cu \
        --kernel other=path/to/other.cu --order tree,other,other,tree [--out DIR]

Each ``--kernel NAME=PATH`` is a CUDA source with K6's C interface
(``sb_group_agg``).  Every source is compiled with the port's nvcc flags
plus ``-Xptxas -v`` (one nvcc each, started together); each entry
function's registers and spills go to stdout.  Each build is then held
equal to ``group_agg_plain`` at every shape below (on 1 M rows, from an
aligned base and from one 4 bytes past it), and timed with CUDA events at
60 M rows (SF10), the builds taking turns in ``--order`` at each shape:

- ``q1``: resident Q1's call, two int32 keys (3 x 2 groups), the mask, five
  int64 values and one count (a thread's own sums, cap bound 8);
- ``regs32``: 20 groups, one int64 value and its count (bound 32);
- ``smem64`` and ``smem4096``: 64 and 4096 groups of Q1's six outputs
  (a block's sums under shared atomics; 4096 takes two launches).

The bound is each distinct input's bytes read once at 3.35 TB/s (H100
SXM).  Results: one JSON line a measurement, and ``<DIR>/k6_variants.json``
(``--out``, default ``_chip/`` in the checkout, git-ignored).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from strawboat_tpu_torch.kernels import _build  # noqa: E402
from strawboat_tpu_torch.kernels import group_agg as ga  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
ROWS = 60_000_000
CHECK_ROWS = 1_000_003
SHAPES = {"q1": (6, 2, 5), "regs32": (20, 1, 1), "smem64": (64, 1, 5), "smem4096": (4096, 1, 5)}


def build(name: str, src: str, out_dir: str) -> str:
    lib = os.path.join(out_dir, f"lib_k6_{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    entry = None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = re.sub(r"^.*group_agg_(\w+?)_kernel", r"\1", m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            print(json.dumps({"kernel": name, "entry": entry, "registers": int(m.group(1))}))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry and int(m.group(1)):
            print(json.dumps({"kernel": name, "entry": entry, "spill_stores": int(m.group(1))}))
    return lib


def inputs(shape: str, n: int, dev, off: int = 0):
    """(keys, cap, mask, outputs) of ``shape`` over ``n`` rows (``off``
    elements past each tensor's base)."""
    cap, n_keys, n_vals = SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(cap)

    def ints(hi, dtype):
        return torch.randint(0, hi, (n + off,), dtype=dtype, device=dev, generator=g)[off:]

    if n_keys == 2:
        keys = [(ints(3, torch.int32), 2), (ints(2, torch.int32), 1)]
    else:
        keys = [(ints(cap, torch.int32), 1)]
    mask = (torch.randint(0, 50, (n + off,), device=dev, generator=g) > 0)[off:]
    vals = [ints(10**9, torch.int64) for _ in range(n_vals)]
    return keys, cap, mask, [(v, None) for v in vals] + [(None, None)]


def nbytes(keys, mask, outputs) -> int:
    ts = {t.data_ptr(): t for t in [k for k, _s in keys] + [mask]
          + [t for o in outputs for t in o if t is not None]}
    return sum(t.numel() * t.element_size() for t in ts.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", action="append", required=True, help="NAME=PATH")
    ap.add_argument("--order", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "_chip"))
    args = ap.parse_args(argv)
    kernels = dict(k.split("=", 1) for k in args.kernel)
    order = args.order.split(",")
    dev = torch.device("cuda")
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        with cf.ThreadPoolExecutor(len(kernels)) as pool:
            libs = dict(zip(kernels, pool.map(lambda kv: build(*kv, tmp), kernels.items())))
        fns = {}
        for name, lib in libs.items():
            fn = getattr(ctypes.CDLL(lib), "sb_group_agg")
            fn.argtypes, fn.restype = list(ga._ENTRY_ARGS), ctypes.c_int
            fns[name] = fn
        real = _build.entry

        def run_with(name, call):
            _build.entry = lambda *_a: fns[name]
            try:
                return call()
            finally:
                _build.entry = real

        results = []
        for shape in SHAPES:
            for off in (0, 1):
                keys, cap, mask, outputs = inputs(shape, CHECK_ROWS, dev, off)
                want = ga.group_agg_plain(keys, cap, mask, outputs)
                for name in kernels:
                    got = run_with(name, lambda: ga.group_agg(keys, cap, mask, outputs))
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} differs from plain at {shape}, offset {off}")
            keys, cap, mask, outputs = inputs(shape, ROWS, dev)
            bound_ms = nbytes(keys, mask, outputs) / HBM_BYTES_PER_S * 1e3
            times = {name: [] for name in kernels}
            for name in order:
                call = lambda: ga.group_agg(keys, cap, mask, outputs)  # noqa: E731
                run_with(name, call)
                torch.cuda.synchronize()
                ts = []
                for _ in range(args.reps):
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    run_with(name, call)
                    b.record()
                    torch.cuda.synchronize()
                    ts.append(a.elapsed_time(b))
                times[name].append(statistics.median(ts))
            for name, ms in times.items():
                row = {"shape": shape, "kernel": name, "ms": ms, "bound_ms": bound_ms,
                       "bound_share": bound_ms / statistics.mean(ms),
                       "launches": len(ga.plan_launches(cap, len(outputs)))}
                print(json.dumps(row), flush=True)
                results.append(row)
            del keys, mask, outputs
            torch.cuda.empty_cache()
    with open(os.path.join(args.out, "k6_variants.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

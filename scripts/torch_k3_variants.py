"""Time builds of kernel K3 against each other on one CUDA card, in turns.

    python3 scripts/torch_k3_variants.py --kernel tree=strawboat_tpu_torch/kernels/csrc/bitunpack_natural.cu \
        --kernel other=path/to/other.cu --order tree,other,other,tree [--scan] [--out DIR]

Each ``--kernel NAME=PATH`` is a CUDA source with K3's C interface
(``sb_bitunpack_natural``).  Every source is compiled with the port's nvcc
flags plus ``-Xptxas -v`` (one nvcc each, started together); the
registers, shared memory and spills of each width go to stdout and the
full ptxas report to ``<DIR>/k3_ptxas_<NAME>.txt``.  Each build is
then held bit-exact against ``bitunpack_natural_plain`` for b = 1..32,
two seeds and tail sizes around its chunk, and timed with CUDA events over
60 M values (SF10) at each ``--widths`` width, the builds taking turns in
``--order`` at each width.  With ``--scan`` it also writes both SF10 files
of ``chip_smoke.py`` and times, in the same turns, the sum over every K3
launch one scan of the two files makes.  The bound is (16·b + 512) bytes
per 128 values at 3.35 TB/s (H100 SXM); as a yardstick of what the card
reaches, it also times torch's ``fill_`` (writes only) and ``copy_`` of
the 60 M-value output.  Results: one JSON line per
measurement, and ``<DIR>/k3_variants.json`` (``--out``, default ``_chip/``
in the checkout, git-ignored).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from strawboat_tpu_torch.kernels import _build  # noqa: E402
from strawboat_tpu_torch.kernels import bitunpack as bu  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
TAILS = (1, 7, 31, 32, 33, 63, 64, 65, 2000)  # around chunks of 32 and 64 blocks


def bound_ms(b: int, n_blocks: int) -> float:
    return (16 * b + 512) * n_blocks / HBM_BYTES_PER_S * 1e3


def compile_kernel(name: str, src: str, build_dir: str, out_dir: str):
    """nvcc with -Xptxas -v → (ctypes entry point, per-width ptxas facts)."""
    out = os.path.join(build_dir, f"lib{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    report = proc.stdout + proc.stderr
    with open(os.path.join(out_dir, f"k3_ptxas_{name}.txt"), "w") as f:
        f.write(report)
    facts = {}
    width = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?ILi(\d+)E", line)
        if m:
            width = int(m.group(1))
            continue
        if width is None:
            continue
        entry = facts.setdefault(width, {})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["smem_static"] = int(m.group(1)) if m else 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
    fn = ctypes.CDLL(out).sb_bitunpack_natural
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, facts, seconds


def run(fn, words: torch.Tensor, seed: int, b: int) -> torch.Tensor:
    """One launch of a build, as ``bu.bitunpack_natural`` makes it."""
    out = torch.empty(words.shape[0] * 128, dtype=torch.int32, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = fn(words.data_ptr(), out.data_ptr(), seed & 0xFFFFFFFF, b, words.shape[0], stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def check(name, fn, device, rng) -> int:
    """Bit-exact against the plain version: b = 1..32, two seeds, tails."""
    cases = 0
    for b in range(1, 33):
        for n_blocks in TAILS:
            w = cs.random_words(rng, 1, n_blocks, 4 * b, device)[0]
            for s in cs.SEEDS:
                got = run(fn, w, s, b)
                torch.cuda.synchronize()
                if not torch.equal(got, bu.bitunpack_natural_plain(w, s, b)):
                    raise AssertionError(f"{name} != plain: b={b} n_blocks={n_blocks} seed={s:#x}")
                cases += 1
    return cases


def scan_groups(device):
    """[(b, words on the card)] of every K3 launch of one scan of both
    SF10 files of ``chip_smoke.py``."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec.scan import k3_launch_groups

    cols = tpch.generate_lineitem(1.0, seed=cs.SEED, rows=cs.SF10_ROWS)
    groups = []
    with tempfile.TemporaryDirectory() as tmpdir:
        for name, flags in cs.FILES.items():
            path = os.path.join(tmpdir, f"lineitem_{name}.str")
            with cs.forcing(flags):
                tpch.write_lineitem(path, cols, max_page_size=cs.PAGE_ROWS,
                                    columns=tpch.INT_COLUMNS)
            for _col, (_codec, b), _pages, words in k3_launch_groups(path):
                groups.append((b, torch.from_numpy(words.view(np.int32)).to(device)))
    return groups


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="append", required=True, metavar="NAME=PATH")
    ap.add_argument("--order", required=True, help="comma-separated NAMEs, the turns at each width")
    ap.add_argument("--widths", default="4,6,7,8,9,10,11,12,16")
    ap.add_argument("--scan", action="store_true", help="also time one scan's K3 launch groups")
    ap.add_argument("--out", default=os.path.join(ROOT, "_chip"), help="directory for the reports")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_variants: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    sources = dict(k.split("=", 1) for k in args.kernel)
    order = args.order.split(",")
    device = torch.device("cuda", 0)
    results = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi(),
               "order": order, "ptxas": {}, "checked_cases": {}, "widths": {}}
    cs.emit("device", kind=results["device"], nvidia_smi=results["nvidia_smi"])

    with tempfile.TemporaryDirectory() as build_dir, cf.ThreadPoolExecutor(len(sources)) as pool:
        futs = {n: pool.submit(compile_kernel, n, os.path.join(ROOT, p), build_dir, args.out)
                for n, p in sources.items()}
        fns = {}
        for n, fut in futs.items():
            fns[n], results["ptxas"][n], secs = fut.result()
            cs.emit("build", kernel=n, source=sources[n], seconds=secs, ptxas=results["ptxas"][n])

        rng = np.random.default_rng(cs.SEED)
        for n, fn in fns.items():
            results["checked_cases"][n] = check(n, fn, device, rng)
        cs.emit("check", bit_exact=True, cases=results["checked_cases"], tails=TAILS)

        n_blocks = cs.SF10_ROWS // 128
        dst = torch.empty(n_blocks * 128, dtype=torch.int32, device=device)
        src = torch.ones_like(dst)
        nbytes = dst.numel() * 4
        fill_ms = cs.event_ms(lambda: dst.fill_(7))
        copy_ms = cs.event_ms(lambda: dst.copy_(src))
        results["yardstick"] = {"fill_ms": fill_ms, "fill_TB_per_s": nbytes / fill_ms / 1e9,
                                "copy_ms": copy_ms, "copy_TB_per_s": 2 * nbytes / copy_ms / 1e9}
        cs.emit("yardstick", **results["yardstick"])
        del dst, src
        for b in map(int, args.widths.split(",")):
            w = cs.random_words(rng, 1, n_blocks, 4 * b, device)[0]
            want = bu.bitunpack_natural_plain(w, 0, b)
            for n, fn in fns.items():
                if not torch.equal(run(fn, w, 0, b), want):
                    raise AssertionError(f"{n} != plain at 60 M values, b={b}")
            del want
            turns = [(n, cs.event_ms(lambda fn=fns[n]: run(fn, w, 0, b))) for n in order]
            results["widths"][b] = {"bound_ms": bound_ms(b, n_blocks), "turns": turns}
            cs.emit("width", b=b, n_values=n_blocks * 128, **results["widths"][b])
            del w
            torch.cuda.empty_cache()

        if args.scan:
            groups = scan_groups(device)
            turns = []
            for n in order:
                turns.append((n, sum(cs.event_ms(lambda fn=fns[n], w=w, b=b: run(fn, w, 0, b))
                                     for b, w in groups)))
            results["scan"] = {"launches": len(groups), "widths": [b for b, _w in groups],
                               "bound_ms": sum(bound_ms(b, w.shape[0]) for b, w in groups),
                               "turns": turns}
            cs.emit("scan", **results["scan"])

    with open(os.path.join(args.out, "k3_variants.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

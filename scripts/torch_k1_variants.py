"""Time builds of kernel K1 against each other on one CUDA card, in turns,
by the device's own time.

    python3 scripts/torch_k1_variants.py --kernel parent=_chip/k1_parent.cu \
        --kernel tree=strawboat_tpu_torch/kernels/csrc/bitunpack.cu \
        --order parent,tree,tree,parent [--per-width tree] [--out DIR]

Each ``--kernel NAME=PATH`` is a CUDA source with K1's C interface: the
single-plane ``sb_bitunpack_tiled``, and where it has one the many-plane
``sb_bitunpack_tiled_many`` (descriptors as ``kernels/bitunpack.py``
``tiled_descriptors`` packs them).  An older tree's source comes from git
into the git-ignored ``_chip/`` (``git show <commit>:strawboat_tpu_torch/
kernels/csrc/bitunpack.cu > _chip/k1_parent.cu``).

Every source is compiled with the port's nvcc flags plus ``-Xptxas -v``
(one nvcc each, started together); a source of ``--per-width``, whose
widths share one kernel, is compiled again once per width with
``-DSB_K1_BITS=b`` for each width's registers.  The registers and spills
of each width go to stdout, the full reports to
``<DIR>/k1_ptxas_<NAME>.txt``.  Each build is held bit-exact against
``bitunpack_tiled_plain`` for b = 1..32 under two seeds at tiles 16384,
512 and 1001 (odd) and from a base 4 bytes past 16, and, where it has the
many-plane entry, over a mixed list of every width and tile.  Then at
each shape — (n, b, 16384) for n = 115 (SF10), 29 (a shard of 4) and 1
at the path's widths, and the planes resident Q6, Q1 and the sharded Q6
decode — the builds take turns in ``--order``: a launch a plane through
the single-plane entry, and one call through the many-plane entry where
there is one.  Every time is the device's own (a ``torch.profiler``
trace, median of the reps) beside the CUDA event window; ``copy_``
(reads and writes the output's bytes) and ``fill_`` (writes them) of an
output-sized buffer are the yardsticks.  The bound is (b + 32) * 4 bytes
per lane column at 3.35 TB/s (H100 SXM).  Results: one JSON line per
measurement, and ``<DIR>/k1_variants.json`` (``--out``, default
``_chip/`` in the checkout, git-ignored).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
from strawboat_tpu_torch.kernels import bitunpack as bu  # noqa: E402
from torch_k3_variants import build  # noqa: E402

TILE = bu.TILE3D
CHECK_TILES = (TILE, 512, 1001)


class Build:
    """One compiled source: its single-plane entry, its many-plane entry or
    None, and its ptxas facts."""

    def __init__(self, lib, facts):
        self.single = lib.sb_bitunpack_tiled
        self.single.argtypes = list(bu._TILED_ARGS)
        self.single.restype = ctypes.c_int
        self.many = getattr(lib, "sb_bitunpack_tiled_many", None)
        if self.many is not None:
            self.many.argtypes = list(bu._MANY_ARGS)
            self.many.restype = ctypes.c_int
        self.facts = facts

    def run_single(self, w: torch.Tensor, b: int, seed: int = 0) -> torch.Tensor:
        """One launch over one plane, as ``bu.bitunpack_tiled`` makes it."""
        n, _, tile = w.shape
        out = torch.empty((n, 32, tile), dtype=torch.int32, device=w.device)
        err = self.single(w.data_ptr(), out.data_ptr(), seed & 0xFFFFFFFF, b, n, tile,
                          torch.cuda.current_stream(w.device).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    def run_many(self, planes, seed: int = 0) -> list:
        """The planes through the many-plane entry, as
        ``bu.bitunpack_tiled_many`` makes it."""
        shapes = [tuple(w.shape) for w, _b in planes]
        sizes = [n * 32 * tile for n, _b, tile in shapes]
        flat = torch.empty(sum(sizes), dtype=torch.int32, device=planes[0][0].device)
        outs = [v.view(n, 32, tile) for v, (n, _b, tile) in zip(flat.split(sizes), shapes)]
        descs = bu.tiled_descriptors(planes, [o.data_ptr() for o in outs], seed)
        stream = torch.cuda.current_stream(planes[0][0].device).cuda_stream
        for lo, hi in bu.plan_tiled_launch(len(planes)):
            err = self.many(descs[lo * bu._PLANE.size : hi * bu._PLANE.size], hi - lo, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        return outs


def compile_all(sources: dict, per_width, build_dir: str, out_dir: str) -> dict:
    """Every source, one nvcc each started together; the sources named in
    ``per_width`` (one kernel for every width) again once per width
    (``-DSB_K1_BITS``)."""
    builds, seconds = {}, {}
    with cf.ThreadPoolExecutor(max(os.cpu_count() or 1, len(sources))) as pool:
        futs = {n: pool.submit(build, n, os.path.join(ROOT, p), build_dir, out_dir, "k1")
                for n, p in sources.items()}
        for n, fut in futs.items():
            lib, facts, seconds[n] = fut.result()
            builds[n] = Build(lib, facts)
        for n in per_width:
            b = builds[n]
            per = {w: pool.submit(build, f"{n}_b{w}", os.path.join(ROOT, sources[n]), build_dir,
                                  out_dir, "k1", (f"-DSB_K1_BITS={w}",))
                   for w in range(1, 33)}
            for w, fut in per.items():
                b.facts[w] = fut.result()[1]["all"]
    for n, b in builds.items():
        cs.emit("build", kernel=n, source=sources[n], seconds=seconds[n],
                many_entry=b.many is not None, ptxas=b.facts)
    return builds


def check(name: str, b: Build, device, rng) -> int:
    """Bit-exact against the plain version: b = 1..32, two seeds, tiles
    16384, 512 and 1001, a base off 16 bytes; the many-plane entry over
    every width and tile."""
    cases = 0
    for bits in range(1, 33):
        words = [cs.random_words(rng, 3, bits, tile, device) for tile in CHECK_TILES]
        flat = cs.random_words(rng, 1, 1, 4 + 2 * bits * 512, device).reshape(-1)
        words.append(flat[1 : 1 + 2 * bits * 512].view(2, bits, 512))
        for w in words:
            for s in cs.SEEDS:
                got = b.run_single(w, bits, s)
                torch.cuda.synchronize()
                if not torch.equal(got, bu.bitunpack_tiled_plain(w, s, bits)):
                    raise AssertionError(f"{name} != plain: b={bits} shape={tuple(w.shape)} "
                                         f"ptr%16={w.data_ptr() % 16} seed={s:#x}")
                cases += 1
    if b.many is not None:
        planes = [(cs.random_words(rng, 2, bits, tile, device), bits)
                  for tile in CHECK_TILES for bits in range(1, 33)]
        for s in cs.SEEDS:
            got = b.run_many(planes, s)
            torch.cuda.synchronize()
            for (w, bits), g in zip(planes, got):
                if not torch.equal(g, bu.bitunpack_tiled_plain(w, s, bits)):
                    raise AssertionError(f"{name} many != plain: b={bits} "
                                         f"shape={tuple(w.shape)} seed={s:#x}")
            cases += len(planes)
    return cases


def shapes_to_time(rng, device) -> dict:
    """name → planes [(words, b)]: single planes at (n, b, 16384) and the
    plane groups of resident Q6, Q1 and the sharded Q6."""
    out = {f"{n}x{b}": [(cs.random_words(rng, n, b, TILE, device), b)]
           for n in cs.K1_TILES for b in cs.PATH_WIDTHS}
    widths = cs.COLUMN_WIDTHS
    out["q6"] = [(cs.random_words(rng, cs.SF10_TILES, widths[c], TILE, device), widths[c])
                 for c in cs.Q6_COLUMNS]
    out["q1"] = [(cs.random_words(rng, cs.SF10_TILES, b, TILE, device), b) for b in widths.values()]
    out["sharded_q6"] = [(cs.random_words(rng, cs.K1_TILES[1], widths[c], TILE, device), widths[c])
                         for _s in range(cs.MULTI_SHARDS) for c in cs.Q6_COLUMNS]
    return out


def time_shape(key: str, planes, builds: dict, order: list) -> dict:
    """Device and event-window times of every build at one shape, in
    turns, with the yardsticks, from one profiler trace."""
    nbytes = cs.k1_bytes(planes)
    out_elems = sum(w.shape[0] * 32 * w.shape[2] for w, _b in planes)
    dst = torch.empty(out_elems, dtype=torch.int32, device=planes[0][0].device)
    src = torch.ones_like(dst)
    variants = []  # (label, fn, launches a call)
    for n in order:
        b = builds[n]
        variants.append((f"{n}/per_plane", lambda b=b: [b.run_single(w, bits) for w, bits in planes],
                         len(planes)))
        if b.many is not None:
            variants.append((f"{n}/many", lambda b=b: b.run_many(planes), 1))
    yard = [("copy_", lambda: dst.copy_(src), 1, "Memcpy"),
            ("fill_", lambda: dst.fill_(7), 1, "Fill")]
    dev = cs.device_ms([(fn, k, "bitunpack") for _l, fn, k in variants]
                       + [(fn, k, m) for _l, fn, k, m in yard])
    turns = [{"variant": label, "device_ms": d, "ms": cs.event_ms(fn),
              "bound_share": cs.bound_ms(nbytes) / d}
             for (label, fn, _k), d in zip(variants, dev)]
    res = {"planes": [[tuple(w.shape), b] for w, b in planes], "bound_ms": cs.bound_ms(nbytes),
           "turns": turns,
           "copy_device_ms": dev[len(variants)], "copy_bytes": 8 * out_elems,
           "copy_TB_per_s": 8 * out_elems / dev[len(variants)] / 1e9,
           "fill_device_ms": dev[len(variants) + 1], "fill_bytes": 4 * out_elems,
           "fill_TB_per_s": 4 * out_elems / dev[len(variants) + 1] / 1e9}
    cs.emit("shape", shape=key, **res)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="append", required=True, metavar="NAME=PATH")
    ap.add_argument("--order", required=True, help="comma-separated NAMEs, the turns at each shape")
    ap.add_argument("--per-width", default="", metavar="NAMES",
                    help="comma-separated NAMEs of sources with one kernel for every width, "
                         "built again once per width for each width's registers")
    ap.add_argument("--out", default=os.path.join(ROOT, "_chip"), help="directory for the reports")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_variants: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    sources = dict(k.split("=", 1) for k in args.kernel)
    order = args.order.split(",")
    device = torch.device("cuda", 0)
    results = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi(),
               "order": order, "ptxas": {}, "checked_cases": {}, "shapes": {}}
    cs.emit("device", kind=results["device"], nvidia_smi=results["nvidia_smi"],
            torch=torch.__version__, cuda=torch.version.cuda)

    with tempfile.TemporaryDirectory() as build_dir:
        builds = compile_all(sources, [n for n in args.per_width.split(",") if n],
                             build_dir, args.out)
        results["ptxas"] = {n: b.facts for n, b in builds.items()}
        rng = np.random.default_rng(cs.SEED)
        for n, b in builds.items():
            results["checked_cases"][n] = check(n, b, device, rng)
        cs.emit("check", bit_exact=True, cases=results["checked_cases"], tiles=CHECK_TILES)
        for key, planes in shapes_to_time(rng, device).items():
            results["shapes"][key] = time_shape(key, planes, builds, order)
            del planes
            torch.cuda.empty_cache()

    with open(os.path.join(args.out, "k1_variants.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

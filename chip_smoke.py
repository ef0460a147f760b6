"""Smoke run of the torch port on one CUDA card: the resident serving
path and the file scan path.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device  — the card's name, and its power limit from nvidia-smi;
2. build   — compile kernels K1 and K3 (``strawboat_tpu_torch/kernels/csrc``)
   with nvcc, one process per source, started together;
3. kernel  — K1 bit-exact against its plain torch version for every width
   1..32 and two seeds, then K1 and plain times at the SF10 plane shapes;
4. kernel_natural — K3 likewise (b = 0..32, two seeds, block counts around
   one CTA's share and 2000), then K3 and plain times over 60 M values at
   the scan's widths and b = 16;
5. generate — TPC-H lineitem, 60 M rows = SF10, seeded numpy;

the resident path (K1's launches are counted over 6–8):

6. load    — ``make_resident(..., device="cuda")``;
7. q6      — ``filter_sum`` Q6 == the numpy reference, warm latency;
8. q1      — ``Query(rt)`` Q1 == the numpy reference (exact; ``avg_*`` to
   rtol 1e-12), warm latency;

the scan path (K3's launches are counted over 9–11):

9. write   — the integer lineitem columns through the port's ``write_file``
   into two files: ``dict`` (STRAWBOAT_DICT_COMPRESSION=1 and
   STRAWBOAT_BITPACK_COMPRESSION=1: DICT pages with bit-packed codes) and
   ``bitpack`` (STRAWBOAT_BITPACK_COMPRESSION=1: l_shipdate bit-packed,
   the int64 columns raw);
10. scan   — ``scan_file(path, device="cuda")`` of each file: every column
   equals the generated one; K3 launched on each; warm median;
11. q6_scan — ``tpch.q6`` over each scanned table == the numpy reference;

and last:

12. k2_k0  — K2 and K0 bit-exact against their plain versions (b = 1..32),
   then (their launches counted) l_shipdate's bit-packed pages decoded
   through K2's and K0's natural-order entry points == the generated column.

Then the kernel summary line (each kernel's launches on its path, its
time and its plain version's over that path's shapes, and ``bound_ms``: the
bytes it must move, each input read once and each output written once, at
the H100 SXM's 3.35 TB/s), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script fails before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CSRC = "strawboat_tpu_torch/kernels/csrc/"
PALLAS = "strawboat_tpu/kernels/bitunpack_pallas.py:"
SF10_ROWS = 60_000_000
SEED = 0
SF10_TILES = 115  # planes of 60 M rows at tile 16384
PATH_WIDTHS = (1, 2, 4, 6, 12, 23)  # plane widths of the Q1/Q6 columns
# block widths K3 meets in the scan: dict index codes 4 and 6 (7 for
# l_shipdate), bit-packed l_shipdate 7..12
SCAN_WIDTHS = (4, 6, 7, 8, 9, 10, 11, 12)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at its 700 W limit
SEEDS = (0, 0xA5A500FF)
REPS = 20
SCAN_REPS = 3
PAGE_ROWS = 65536
FILES = {
    "dict": {"STRAWBOAT_DICT_COMPRESSION": "1", "STRAWBOAT_BITPACK_COMPRESSION": "1"},
    "bitpack": {"STRAWBOAT_BITPACK_COMPRESSION": "1"},
}


def emit(phase: str, **facts) -> None:
    print(json.dumps({"phase": phase, **facts}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = REPS) -> float:
    """Median host time of ``fn()`` in ms; ``fn`` ends in a host copy or a
    synchronize, so the device work is inside the window."""
    fn()  # warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    """The least time the card takes to move ``nbytes`` of device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def random_words(rng, n_tiles: int, b: int, tile: int, device) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, (n_tiles, b, tile), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def phase_kernel(device, seed: int, tile: int, n_tiles: int) -> dict:
    """K1 vs its plain version: every width and seed at (8, b, tile), then
    times at the path's plane shapes.  Returns the kernel summary."""
    from strawboat_tpu_torch.kernels import bitunpack as bu

    rng = np.random.default_rng(seed)
    max_err = 0
    for b in range(1, 33):
        w = random_words(rng, 8, b, tile, device)
        for s in SEEDS:
            got = bu.bitunpack_tiled(w, s, b)
            want = bu.bitunpack_tiled_plain(w, s, b)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if err:
                raise AssertionError(f"K1 disagrees with plain: b={b} seed={s:#x} err={err}")
            max_err = max(max_err, err)
    times = {}
    for b in PATH_WIDTHS:
        w = random_words(rng, n_tiles, b, tile, device)
        got = bu.bitunpack_tiled(w, 0, b)
        err = int((got.long() - bu.bitunpack_tiled_plain(w, 0, b).long()).abs().max())
        if err:
            raise AssertionError(f"K1 disagrees with plain at the path shape: b={b}")
        ms = event_ms(lambda: bu.bitunpack_tiled(w, 0, b))
        plain_ms = event_ms(lambda: bu.bitunpack_tiled_plain(w, 0, b))
        nbytes = (b + 32) * 4 * n_tiles * tile
        times[b] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes),
                    "GB_per_s": nbytes / 1e6 / ms, "plain_GB_per_s": nbytes / 1e6 / plain_ms}
    emit("kernel", widths_checked=32, seeds=[hex(s) for s in SEEDS], max_abs_err=max_err,
         shape=[n_tiles, "b", tile], times=times)
    return {"max_abs_err": max_err, "times": times}


def phase_load(cols, device) -> object:
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import make_resident

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    planes = {
        n: {"bits": [b for _w, b in c.planes],
            "bytes": sum(w.numel() * 4 for w, _b in c.planes)}
        for n, c in rt.columns.items()
    }
    emit("load", rows=rt.num_rows, tile=rt.tile, load_s=load_s, planes=planes,
         plane_bytes=sum(p["bytes"] for p in planes.values()),
         memory_allocated=torch.cuda.memory_allocated(),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return rt


def phase_q6(rt, cols) -> None:
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.kernels import bitunpack as bu

    before = bu.bitunpack_tiled.launches
    got = int(tpch.q6(rt))
    launched = bu.bitunpack_tiled.launches - before
    want = tpch.q6_numpy_reference(cols)
    if got != want:
        raise AssertionError(f"Q6 {got} != numpy {want}")
    if launched <= 0:
        raise AssertionError("Q6 did not launch K1")
    ms = wall_ms(lambda: int(tpch.q6(rt)))
    emit("q6", revenue=got, equal_to_numpy=True, k1_launches=launched, warm_median_ms=ms)


def phase_q1(rt, cols) -> None:
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.kernels import bitunpack as bu

    before = bu.bitunpack_tiled.launches
    res = tpch.q1(rt)
    launched = bu.bitunpack_tiled.launches - before
    got = tpch.q1_rows(res)
    want = tpch.q1_numpy_reference(cols)
    if list(got) != list(want):
        raise AssertionError(f"Q1 groups {list(got)} != numpy {list(want)}")
    for key, aggs in want.items():
        for name, w in aggs.items():
            g = got[key][name]
            if name.startswith("avg_"):
                np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=f"Q1 {key} {name}")
            elif g != w:
                raise AssertionError(f"Q1 {key} {name}: {g} != numpy {w}")
    if launched <= 0:
        raise AssertionError("Q1 did not launch K1")
    ms = wall_ms(lambda: tpch.q1(rt))
    emit("q1", groups=len(got), equal_to_numpy=True, k1_launches=launched, warm_median_ms=ms,
         count_order=sum(a["count_order"] for a in got.values()))


def k3_bytes(b: int, n_blocks: int) -> int:
    """What K3 must move: 16·b bytes in and 512 out per 128 values."""
    return (16 * b + 512) * n_blocks


def phase_kernel_natural(device, seed: int) -> dict:
    """K3 vs its plain version for every width 0..32 and seed, at block
    counts around one CTA's share (the masked tail) and 2000, then K3 and
    plain over 60 M values at the scan widths and b = 16.  Returns the
    kernel summary."""
    from strawboat_tpu_torch.kernels import bitunpack as bu

    rng = np.random.default_rng(seed)
    cta = bu.NATURAL_CTA_BLOCKS
    tails = (1, 7, cta - 1, cta, cta + 1, 2000)
    for b in range(0, 33):
        for n_blocks in tails:
            w = random_words(rng, 1, n_blocks, 4 * b, device)[0]
            for s in SEEDS:
                got = bu.bitunpack_natural(w, s, b)
                torch.cuda.synchronize()
                if not torch.equal(got, bu.bitunpack_natural_plain(w, s, b)):
                    raise AssertionError(
                        f"K3 disagrees with plain: b={b} n_blocks={n_blocks} seed={s:#x}")
    n_blocks = SF10_ROWS // 128
    times = {}
    for b in SCAN_WIDTHS + (16,):
        w = random_words(rng, 1, n_blocks, 4 * b, device)[0]
        if not torch.equal(bu.bitunpack_natural(w, 0, b), bu.bitunpack_natural_plain(w, 0, b)):
            raise AssertionError(f"K3 disagrees with plain at 60 M values: b={b}")
        ms = event_ms(lambda: bu.bitunpack_natural(w, 0, b))
        plain_ms = event_ms(lambda: bu.bitunpack_natural_plain(w, 0, b))
        nbytes = k3_bytes(b, n_blocks)
        times[b] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes),
                    "GB_per_s": nbytes / 1e6 / ms, "plain_GB_per_s": nbytes / 1e6 / plain_ms}
        del w
    emit("kernel_natural", widths_checked=33, seeds=[hex(s) for s in SEEDS], max_abs_err=0,
         n_blocks_checked=tails, n_values=n_blocks * 128, times=times)
    return {"max_abs_err": 0}


@contextlib.contextmanager
def forcing(flags):
    """Set the STRAWBOAT_*_COMPRESSION flags for the block, then restore."""
    keys = ("STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION",
            "STRAWBOAT_RLE_COMPRESSION", "STRAWBOAT_FREQ_COMPRESSION")
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k in keys:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def phase_write(cols, tmpdir) -> dict:
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import native_available

    paths = {}
    facts = {}
    for name, flags in FILES.items():
        path = os.path.join(tmpdir, f"lineitem_{name}.str")
        with forcing(flags):
            t0 = time.perf_counter()
            metas = tpch.write_lineitem(path, cols, max_page_size=PAGE_ROWS)
            facts[name] = {"seconds": time.perf_counter() - t0, "bytes": os.path.getsize(path),
                           "pages_per_column": len(metas[0].pages), "flags": flags}
        paths[name] = path
    from strawboat_tpu_torch import native

    emit("write", rows=SF10_ROWS, page_rows=PAGE_ROWS, native_available=native_available(),
         native_error=native.load_error(), files=facts)
    return paths


def phase_scan(paths, cols, device) -> dict:
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import scan_file
    from strawboat_tpu_torch.exec.scan import host_values
    from strawboat_tpu_torch.kernels import bitunpack as bu

    tables = {}
    facts = {}
    for name, path in paths.items():
        before = bu.bitunpack_natural.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        table = scan_file(path, device=device)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launched = bu.bitunpack_natural.launches - before
        if launched <= 0:
            raise AssertionError(f"scan of the {name} file did not launch K3")
        for k in tpch.INT_COLUMNS:
            if not np.array_equal(host_values(table[k]), cols[k]):
                raise AssertionError(f"scanned {name} column {k} != the generated column")
        del table
        torch.cuda.empty_cache()
        times = []
        for _ in range(SCAN_REPS):
            t0 = time.perf_counter()
            table = scan_file(path, device=device)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del table
        tables[name] = scan_file(path, device=device)
        facts[name] = {"cold_s": cold_s, "warm_median_ms": statistics.median(times),
                       "warm_ms": times, "k3_launches": launched, "equal_to_numpy": True,
                       "decoded_bytes": sum(c.values.numel() * c.values.element_size()
                                            for c in tables[name].columns.values()),
                       "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit("scan", files=facts)
    return tables


def phase_q6_scan(tables, cols) -> None:
    from strawboat_tpu_torch.benchsuite import tpch

    want = tpch.q6_numpy_reference(cols)
    facts = {}
    for name, table in tables.items():
        got = int(tpch.q6(table))
        if got != want:
            raise AssertionError(f"Q6 over the scanned {name} file {got} != numpy {want}")
        facts[name] = {"revenue": got, "warm_median_ms": wall_ms(lambda: int(tpch.q6(table)))}
    emit("q6_scan", equal_to_numpy=True, files=facts)


def k3_summary(paths, device) -> dict:
    """K3 and plain times, and the bound, over every launch one scan of
    both files makes."""
    from strawboat_tpu_torch.exec.scan import k3_launch_groups
    from strawboat_tpu_torch.kernels import bitunpack as bu

    ms = plain_ms = nbytes = 0.0
    for path in paths.values():
        for _col, (_codec, b), _pages, words in k3_launch_groups(path):
            w = torch.from_numpy(words.view(np.int32)).to(device)
            ms += event_ms(lambda: bu.bitunpack_natural(w, 0, b))
            plain_ms += event_ms(lambda: bu.bitunpack_natural_plain(w, 0, b))
            nbytes += k3_bytes(b, words.shape[0])
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes)}


def phase_k2_k0(path: str, shipdate: np.ndarray, device, seed: int) -> dict:
    """K2 and K0 against their plain versions at every width, then — their
    launches counted — l_shipdate's bit-packed pages decoded through their
    natural-order entry points, equal to the generated column."""
    from strawboat_tpu_torch.exec.scan import k3_launch_groups
    from strawboat_tpu_torch.kernels import bitunpack as bu

    rng = np.random.default_rng(seed)
    for b in range(1, 33):
        w3 = random_words(rng, 4, b, bu.TILE3D, device)
        if not torch.equal(bu.bitunpack_tiled_unseeded(w3, b), bu.bitunpack_tiled_unseeded_plain(w3, b)):
            raise AssertionError(f"K2 disagrees with plain: b={b}")
        wt = random_words(rng, 1, b, 512 * 97, device)[0]
        if not torch.equal(bu.bitunpack_tmajor(wt, b), bu.bitunpack_tmajor_plain(wt, b)):
            raise AssertionError(f"K0 disagrees with plain: b={b}")
    torch.cuda.synchronize()

    groups = [(b, pages, words)
              for _col, (_codec, b), pages, words in k3_launch_groups(path, ["l_shipdate"])]
    inputs = []
    for b, pages, words in groups:
        flat = words.reshape(-1)
        want = np.concatenate([shipdate[i * PAGE_ROWS : (i + 1) * PAGE_ROWS] for i in pages])
        w3 = torch.from_numpy(bu.transpose_words_host_tiled(flat, b).view(np.int32)).to(device)
        wt = torch.from_numpy(bu.transpose_words_host(flat, b).view(np.int32)).to(device)
        inputs.append((b, want, w3, wt))
    # the K2 / K0 path: counts from 0
    bu.bitunpack_tiled_unseeded.launches = 0
    bu.bitunpack_tmajor.launches = 0
    for b, want, w3, wt in inputs:
        n = len(want)
        k2 = bu.bitunpack_tiled_to_flat(bu.bitunpack_tiled_unseeded(w3, b))[:n]
        k0 = bu.bitunpack_tmajor_natural(wt, b)[:n]
        for name, got in (("K2", k2), ("K0", k0)):
            if not np.array_equal(got.cpu().numpy(), want):
                raise AssertionError(f"{name} path over l_shipdate b={b} != the generated column")
    launches = {"K2": bu.bitunpack_tiled_unseeded.launches, "K0": bu.bitunpack_tmajor.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the K2/K0 path did not launch both kernels: {launches}")
    times = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for k in ("K2", "K0")}
    for b, _want, w3, wt in inputs:
        times["K2"]["ms"] += event_ms(lambda: bu.bitunpack_tiled_unseeded(w3, b))
        times["K2"]["plain_ms"] += event_ms(lambda: bu.bitunpack_tiled_unseeded_plain(w3, b))
        times["K0"]["ms"] += event_ms(lambda: bu.bitunpack_tmajor(wt, b))
        times["K0"]["plain_ms"] += event_ms(lambda: bu.bitunpack_tmajor_plain(wt, b))
        # b words in, 32 values out per lane column
        times["K2"]["bound_ms"] += bound_ms(w3.numel() * 4 * (b + 32) // b)
        times["K0"]["bound_ms"] += bound_ms(wt.numel() * 4 * (b + 32) // b)
    emit("k2_k0", widths_checked=32, max_abs_err=0, path_widths=[g[0] for g in groups],
         launches=launches, times=times, equal_to_numpy=True)
    return {k: {"launches": launches[k], "max_abs_err": 0, **times[k]} for k in launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.kernels import _build, bitunpack as bu

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.load_all(["bitunpack", "bitunpack_natural"])
    emit("build", kernels=["bitunpack", "bitunpack_natural"], seconds=time.perf_counter() - t0,
         compile_seconds=dict(_build.build_seconds), nvcc=_build.nvcc_path())

    k1 = phase_kernel(device, SEED, bu.TILE3D, SF10_TILES)
    k3 = phase_kernel_natural(device, SEED)

    t0 = time.perf_counter()
    cols = tpch.generate_lineitem(1.0, seed=SEED, rows=SF10_ROWS)
    emit("generate", rows=SF10_ROWS, seed=SEED, seconds=time.perf_counter() - t0)

    # the resident path: count only its launches
    bu.bitunpack_tiled.launches = 0
    rt = phase_load(cols, device)
    phase_q6(rt, cols)
    phase_q1(rt, cols)
    k1_launches = bu.bitunpack_tiled.launches
    if k1_launches <= 0:
        raise AssertionError("the resident path never launched K1")
    # K1 over every plane one Q1/Q6 pass decodes, at the loaded shapes
    planes = [(w, b) for c in rt.columns.values() for w, b in c.planes]
    k1["ms"] = sum(event_ms(lambda w=w, b=b: bu.bitunpack_tiled(w, 0, b)) for w, b in planes)
    k1["plain_ms"] = sum(
        event_ms(lambda w=w, b=b: bu.bitunpack_tiled_plain(w, 0, b)) for w, b in planes
    )
    k1["bound_ms"] = sum(bound_ms(w.numel() * 4 * (b + 32) // b) for w, b in planes)
    del rt, planes
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmpdir:
        # the scan path: count only its launches
        bu.bitunpack_natural.launches = 0
        paths = phase_write(cols, tmpdir)
        tables = phase_scan(paths, cols, device)
        phase_q6_scan(tables, cols)
        k3_launches = bu.bitunpack_natural.launches
        if k3_launches <= 0:
            raise AssertionError("the scan path never launched K3")
        del tables
        torch.cuda.empty_cache()
        k3.update(k3_summary(paths, device))
        k2_k0 = phase_k2_k0(paths["bitpack"], cols["l_shipdate"], device, SEED)

    def line(name, src, replaces, launches, facts):
        return {"name": name, "route": "cuda", "source": CSRC + src, "replaces": PALLAS + replaces,
                "launches": launches, "max_abs_err": facts["max_abs_err"], "ms": facts["ms"],
                "plain_ms": facts["plain_ms"], "bound_ms": facts["bound_ms"], "bound_by": "bytes",
                # no single torch call unpacks BitPacker4x
                "library_ms": None}

    print(json.dumps({"kernels": [
        line("bitunpack_tiled", "bitunpack.cu", "222", k1_launches, k1),
        line("bitunpack_tiled_unseeded", "bitunpack.cu", "174", k2_k0["K2"]["launches"], k2_k0["K2"]),
        line("bitunpack_tmajor", "bitunpack.cu", "41", k2_k0["K0"]["launches"], k2_k0["K0"]),
        line("bitunpack_natural", "bitunpack_natural.cu", "298", k3_launches, k3),
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

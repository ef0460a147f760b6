"""Smoke run of the torch port on one CUDA card: the resident serving
path and the file scan path.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device  — the card's name, and its power limit from nvidia-smi;
2. build   — compile kernels K1, K3, K6 and K7 (``strawboat_tpu_torch/kernels/csrc``)
   with nvcc, one process per source, started together;
3. kernel  — K1 bit-exact against its plain torch version for every width
   1..32 and two seeds; ``bitunpack_tiled_many`` (one launch over a list
   of planes) against the plain version over widths 1..32 at tiles 16384
   and 512 and both seeds, past one launch's cap of planes, at an odd tile
   and from a base off 16 bytes; then K1's event-window and device times
   (``torch.profiler``) against the bound and a ``copy_`` of the same bytes
   at (115, b, 16384) (SF10), (29, b, 16384) (a shard of 4) and (1, b,
   16384) for the path's widths, and over the planes resident Q6, Q1 and
   the sharded Q6 decode (one call held equal to the plain version plane
   by plane), a launch a plane against one launch;
4. kernel_natural — K3 likewise (b = 0..32, two seeds, block counts around
   one CTA's share and 2000), then K3 and plain times over 60 M values at
   the scan's widths and b = 16;
5. generate — TPC-H lineitem, 60 M rows = SF10, seeded numpy;

the resident path (K1's launches are counted over 6–8):

6. load    — ``make_resident(..., device="cuda")``;
7. q6      — ``filter_sum`` Q6 == the numpy reference, one K1 launch, one
   K7 launch and no filter_sum on the torch route (``k7.torch_routes``),
   warm latency;
8. q1      — ``Query(rt)`` Q1 == the numpy reference (exact; ``avg_*`` to
   rtol 1e-12), one K1 launch, one K6 launch, warm latency;
8a. k6     — K6 (``csrc/group_agg.cu``) on the inputs resident Q1 hands it
   at SF10 (the key codes, the filter's mask and the five distinct values):
   equal to its plain version, one launch; its event-window and device
   times against the bound (the distinct inputs' bytes at 3.35 TB/s), the
   plain version's time;
8b. k7     — K7 (``csrc/filter_sum.cu``) on the inputs resident Q6 hands it
   at SF10 (K1's words of its four columns, the three bounds): equal to its
   plain version, one launch; its event-window and device times against
   the bound (the rows' bytes of each input at 3.35 TB/s), the plain
   version's time;

the scan path (K3's launches are counted over 9–11):

9. write   — the integer lineitem columns through the port's ``write_file``
   into two files: ``dict`` (STRAWBOAT_DICT_COMPRESSION=1 and
   STRAWBOAT_BITPACK_COMPRESSION=1: DICT pages with bit-packed codes) and
   ``bitpack`` (STRAWBOAT_BITPACK_COMPRESSION=1: l_shipdate bit-packed,
   the int64 columns raw);
10. scan   — ``scan_file(path, device="cuda")`` of each file: every column
   equals the generated one; K3 launched on each; warm median;
11. q6_scan — ``tpch.q6`` over each scanned table == the numpy reference;

the general path (K1's and K3's launches are counted over 12):

12. general — the orders file (SF10 orders, 15 M rows, seed 1, under the
   ``dict`` flags); the Q3-shaped join through ``Query`` over the two files
   and through ``q3_like`` over their scans == the numpy reference; a
   ``Query`` over the lineitem file grouped by l_suppkey (10 000 groups,
   the capacity grows from 4096), ordered and limited; two top-k
   projections; over the resident table a group-by on l_quantity (not a
   dictionary column), a projection with a limit, and Q1's aggregates
   through ``hash_aggregate`` == the fused Q1; ``load_resident`` of the
   dict file (planes == ``make_resident`` of the numpy columns) and
   ``make_resident(scan_file(bitpack file))``, each with Q6 == numpy;

the whole lineitem file (K1's and K3's launches are counted over 13):

13. lineitem_full — the ten lineitem columns (three utf8) through
   ``tpch.write_lineitem`` under the ``dict`` flags with zone maps;
   ``scan_file`` of the file (every column, strings as ``dictionary[codes]``,
   equal to the generated one; K3 launches on the string index pages
   counted alone); Q6 over ``scan_file(predicates=q6_pruning_predicates())``
   == numpy, with the pages kept and the pruned and unpruned times;
   ``tpch.q1_query`` over the file == numpy; ``load_resident`` of the ten
   columns with the fused Q1 and Q6 == numpy;

the file-format API (K3's launches are counted over 14):

14. file_api — over the lineitem_full file: ``api.read_table`` plain and
   twice through one ``ReadArena`` (every column of the plain and the
   recycled read equal to the generated one), ``api.iter_batches`` over
   the first 200 pages (each batch equal to the generated rows),
   ``stat.stat_simple`` of every column (pages by codec), ``scan_file`` on
   the card with ``to_arrow`` (equal to the plain read), each timed; a
   file of int64 and ``pa.nulls`` through ``NativeWriter``, scanned on the
   card (the null column's int32 zeros and False validity there), through
   ``Query`` and through ``read_table`` (a ``null`` column);

the typed lineitem files (K1's and K3's launches are counted over 15):

15. lineitem_typed — every 5th row (12 M, SF2) of the ten lineitem
   columns with the money columns typed: as ``decimal128(15, 2)`` under the ``dict`` flags with zone maps
   (whole scan, every column equal to the generated one in unscaled ints;
   Q6 over a scan pruned by the l_shipdate zones, Q1 through ``Query``
   over the file, ``load_resident`` with the fused Q1 and Q6: all exact),
   and as float64 under no flag (raw pages, through the streamed feed)
   with zone maps (scanned whole twice; Q6 and Q1 over the scan, then
   ``make_resident`` of the scan and the resident Q6 / Q1 through K1:
   counts exact, sums and averages to rtol 1e-12); then l_extendedprice
   as float64 under the PATAS flag and ``l_linestatus == "F"`` as a bool
   column, written and scanned bit for bit;

the nested orders file (K1's and K3's launches are counted over 16):

16. nested — TPC-H orders at SF2.5 (3.75 M rows, seed 1, in o_orderdate
   order) with their 1–7 lineitems each (about 15 M, seed 0) nested as
   ``o_lineitems`` list<struct<l_quantity, l_extendedprice, l_discount,
   l_tax, l_shipdate, l_returnflag>> and ``o_lineprices`` list<int64>,
   written under the ``dict`` flags with zone maps; scanned whole twice
   (every column, offsets and leaf equal to numpy; the host time of the
   level work beside the whole scan's); Q6 over the leaves and
   ``list_segment_sum`` == numpy; a scan pruned by o_orderdate (1994),
   row-aligned; ``scan_chunks`` of 32 pages; ``load_resident`` with
   ``list_sum`` and every leaf decoded from its planes through K1;
   ``make_resident`` of the scan's list column;

the adaptive write path (K3's launches are counted over 17):

17. adaptive — the ten lineitem columns, the first 15 M generated rows
   (SF2.5), through ``write_file`` with the JAX benchmark's write options
   (LZ4, ratio 1.0, sample_seed 3, pages of 65 536 rows, zone maps):
   seconds and bytes, the codecs chosen (a handler on the port's logger)
   and each column's page codecs; scanned whole twice (every column equal
   to the generated one); Q6 over a pruned scan and ``tpch.q1_query`` ==
   numpy; then the scanned table ordered by l_suppkey on the card and
   written again through ``write_device_table`` (the seconds in the stats
   reductions on the card against the host encode), rescanned
   (every column equal to numpy permuted alike) and scanned pruned by
   ``l_suppkey < 1000`` (the kept pages' rows equal numpy's);

the dataset path (K1's and K3's launches are counted over 18):

18. dataset — the ten lineitem columns at SF10 sorted by l_shipdate,
   written by ``write_dataset`` in 60 parts of 1 M rows with the same
   options; ``scan_dataset`` of the glob cold and warm (every column equal
   to the sorted one); Q6 over the scan pruned by Q6's range (files kept by
   their footers, pages kept), then through a manifest (the same files)
   and through ``Query(glob)``, Q1 through ``Query(glob)``; l_extendedprice
   summed over ``iter_dataset_chunks``; ``load_resident`` of the glob
   (planes == ``make_resident`` of the sorted columns, word for word) with
   the resident Q6 and Q1; ``compact_dataset`` of the first 8 parts into 2
   (every column equal, Q6); a warm scan inside ``device_trace``: the
   device's idle share and longest idle gap;

the multi-device path (K1's and K3's launches are counted over 19):

19. multidevice — a mesh of 4 shards on the one card
   (``strawboat_tpu_torch/parallel``): the SF10 resident table sharded by
   tile blocks, Q6 (``sharded_filter_sum``, one K1 launch over every
   shard's planes) and the sums by l_returnflag (``sharded_group_sum``) ==
   the single-device ``filter_sum`` / ``group_sum``, median of 10 warm
   calls each; ``distributed_scan`` of the
   ``dict`` file (each shard's columns == numpy over its page range,
   padding rows not ``__valid__``); ``distributed_aggregate`` of it by
   l_suppkey (grown from 4096 groups) == numpy, its exchange's bytes,
   CUDA-event ms and bound, and its device idle share (``device_trace``);
   ``distributed_join`` of lineitem with the orders file, revenue over
   o_orderdate < 1995-03-15 == numpy; ``distributed_scan_dataset`` of the
   60 parts (global dictionaries of the three utf8 columns; every shard ==
   numpy); ``shuffle_by_key`` of its l_returnflag codes with and without
   salt 4 (every row once; rows per shard printed);
   ``streamed_dataset_aggregate`` by l_suppkey with Q6's range pruning
   parts == numpy; ``dryrun_multidevice(4, "cuda")``; a warm sharded and
   single-device Q6 each inside ``device_trace``, with their longest
   kernels' device ms;

the mesh across processes (K1's and K3's launches are counted over 20,
this process's and its ranks'):

20. multiprocess — at multidevice's width (4 shards, SF10): (a) a world
   of one process under NCCL on the card (``distributed_init`` through a
   ``file://`` store): the sharded Q6 (one K1 launch) and grouped sums,
   ``distributed_scan`` of the ``dict`` file, ``distributed_aggregate`` by
   l_suppkey (from 4096 groups, grown) and ``distributed_join`` with the
   orders file, each equal to the multidevice phase's answer, the
   process group's events in a traced Q6, and the group destroyed; (b) a
   world of two processes on the card under gloo (NCCL refuses two ranks
   on one card), spawned here, two shards each: each rank loads the
   resident table from the lineitem_full file and keeps its tiles, and
   its sharded Q6 (one K1 launch) and grouped sums, ``distributed_scan``
   of the ``dict`` file, ``distributed_aggregate`` and
   ``distributed_scan_dataset`` give the multidevice phase's shards (the
   scans' shards handed over on the card, the aggregate's slots also
   against numpy); each rank's warm Q6 against the single-process mesh's,
   the exchanges' bytes crossed between processes and their ms;

the port's last slice (K1's and K3's launches are counted over 21, this
process's and its config scripts'):

21. port_close — fixed-size binaries: 20 M rows (of SF10's 60 M, a cut
   the phase's budget forces) of ``flag`` fixed_size_binary[1],
   ``country`` [2], ``ipv4`` [4] and ``hash64`` [8] written under the
   ``dict`` flags with zone maps, and 2 M rows of a
   list<fixed_size_binary[2]> column, and the four again under the
   ``bitpack`` flags; ``scan_file`` of both on the card (each column the
   generated integers of its width; K3 decodes flag's DICT index pages
   and every whole page of the bit-packed ipv4, a launch a planned
   group), a ``Query`` filter on ipv4's range == numpy, ``read_table`` ==
   the generated table, ``load_resident`` refused as in the reference;
   ``q1_dense`` over a scan of the lineitem_full file == ``q1`` == numpy,
   each warm; then the scripts of BASELINE configs 4 and 5
   (``examples/torch_tpch_bench.py`` at SF0.1,
   ``examples/torch_resident_query.py``, ``examples/torch_bench_write.py``
   up to 2^16 rows, ``scripts/torch_dist_sf1_stream.py`` at 1 M rows over
   4 shards, ``scripts/torch_scaling_proxy.py`` at 1 and 4 shards) as
   subprocesses on the card, run together: each must exit 0 with its
   checks passed; their seconds and summaries are printed;

and last:

22. k2_k0  — K2 and K0 bit-exact against their plain versions (b = 1..32),
   then (their launches counted) l_shipdate's bit-packed pages decoded
   through K2's and K0's natural-order entry points == the generated column;
   each width group's lane count, times and bound are printed;
23. k1_batching — resident Q6, Q1 and the sharded Q6 warm with their
   planes in one K1 call and a launch a plane, in turns.

The launches line also tallies the planes the paths hand K1 by tile
count, and what its calls of 1-tile planes alone cost by the kernel
phase's (1, b) device time; the ``k1_groups`` line holds each table's
planes through one call equal to the plain version.  Then the kernel
summary line (each kernel's launches on its paths, its
time and its plain version's over that path's shapes — ``ms`` the CUDA
event window around the wrapper, ``device_ms`` the kernel's own duration
from a ``torch.profiler`` trace — and ``bound_ms``: the bytes it must
move, each input read once and each output written once, at the H100
SXM's 3.35 TB/s), the nvidia-smi line, and as the last line
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

from strawboat_tpu_torch.util import obs

CSRC = "strawboat_tpu_torch/kernels/csrc/"
PALLAS = "strawboat_tpu/kernels/bitunpack_pallas.py:"
SF10_ROWS = 60_000_000
SEED = 0
SF10_TILES = 115  # planes of 60 M rows at tile 16384
PATH_WIDTHS = (1, 2, 4, 6, 12, 23)  # plane widths of the Q1/Q6 columns
# the resident table's plane widths (phase load checks them) and the
# columns each query decodes in one K1 launch
COLUMN_WIDTHS = {"l_quantity": 6, "l_extendedprice": 23, "l_discount": 4, "l_tax": 4,
                 "l_returnflag": 2, "l_linestatus": 1, "l_shipdate": 12}
Q6_COLUMNS = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
# block widths K3 meets in the scan: dict index codes 4 and 6 (7 for
# l_shipdate), bit-packed l_shipdate 7..12
SCAN_WIDTHS = (4, 6, 7, 8, 9, 10, 11, 12)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at its 700 W limit
SEEDS = (0, 0xA5A500FF)
# timed calls a warm median takes: kernels, resident queries, the K1 and
# K3 rows' traces (a whole scan's median takes SCAN_REPS)
REPS = 10
SCAN_REPS = 3
PAGE_ROWS = 65536
# SF2.5 orders (TPC-H spec 1.2: SF x 1.5 M); the SF10 and SF5 numbers
# are in PERF.md
NESTED_ORDERS = 3_750_000
# lineitem_typed takes every 5th row (12 M, SF2, every ship date's range
# kept); its SF10 numbers are in PERF.md (PR 6)
TYPED_STRIDE = 5
# the dataset phase: parts of 1 M rows, Databend's row_per_block default
# for its fuse tables; chunks of 16 pages (one part each)
DATASET_PART_ROWS = 1_000_000
DATASET_CHUNK_PAGES = 16
DATASET_K3_REPS = 5
# the adaptive phase takes the first 15 M generated rows (SF2.5); its SF10
# and SF5 numbers are in PERF.md
ADAPTIVE_ROWS = 15_000_000
# the multidevice phase: shards of the mesh on the one card, and Q3's date
# (1995-03-15 in days since 1992-01-01)
MULTI_SHARDS = 4
# the file_api phase reads the first this many pages through iter_batches
# (the whole SF10 file, 916 pages a column, would take most of its budget)
FILE_API_BATCHES = 200
# tiles of the K1 shapes timed: SF10's planes, a shard's, one tile
K1_TILES = (SF10_TILES, -(-SF10_TILES // MULTI_SHARDS), 1)
# TPC-H Q6 as ``filter_sum`` / ``sharded_filter_sum`` arguments (code bounds)
Q6_FILTER_SUM = ({"l_shipdate": (731, 1096), "l_discount": (5, 8), "l_quantity": (None, 24)},
                 "l_extendedprice", "l_discount")
Q3_DATE = 1169
# the port_close phase: fixed-size binaries at 20 M rows (of SF10's 60 M;
# the phase's budget forces the cut), a list<fixed_size_binary[2]> file of
# 2 M rows, and the scripts of BASELINE configs 4 and 5 as subprocesses
# (run together; each ends in its JSON summary)
FIXED_ROWS = 20_000_000
FIXED_LIST_ROWS = 2_000_000
SCRIPT_LIMIT_S = 300
CONFIG_SCRIPTS = (
    ("examples/torch_tpch_bench.py", ["--scale", "0.1"], {}),
    ("examples/torch_resident_query.py", [], {}),
    ("examples/torch_bench_write.py", ["--max-log2", "16"], {}),
    ("scripts/torch_dist_sf1_stream.py", ["--rows", "1000000", "--shards", "4"], {}),
    ("scripts/torch_scaling_proxy.py", ["--shards", "4"], {}),
)
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


def whole_trace(tr, what: str):
    """``tr``, a ``device_trace``; raises when its trace lacks kernels that
    its window launched (its busy time and idle share would miss them)."""
    if tr.lost_kernels:
        raise AssertionError(
            f"{what}: the trace lacks {tr.lost_kernels} kernels its window launched (launched "
            f"from {tr.lost_span_s[0]:.6f} s to {tr.lost_span_s[1]:.6f} s of its "
            f"{tr.window_s:.6f} s)")
    return tr


def traced(logdir: str, device, what: str, fn):
    """``fn()`` inside ``device_trace`` → (the trace, ``fn``'s result, what
    the first try lacked or None).  Late in a long process a profiler
    session sometimes misses kernels its window launched (one SF10 run on
    the H100 lost 815 of a dataset scan's, PERF.md §7); such a trace is
    taken once more, the first try's loss kept for the phase's line, and a
    second trace that lacks kernels fails (``whole_trace``)."""
    from strawboat_tpu_torch.util.obs import device_trace

    first = None
    for _ in range(2):
        with device_trace(logdir, device) as tr:
            out = fn()
        if not tr.lost_kernels:
            return tr, out, first
        first = {"lost_kernels": tr.lost_kernels, "launched_from_s": tr.lost_span_s[0],
                 "launched_to_s": tr.lost_span_s[1], "window_s": tr.window_s}
        os.remove(tr.path)
    whole_trace(tr, what)


def kernel_launches() -> int:
    """Launches the hand-written kernels' wrappers have counted (K1, K2,
    K0 and K3)."""
    return sum(obs.counter(f"k{i}.launches") for i in range(4))


def kernel_counts(base=None) -> dict:
    """K1's and K3's launch counters (``util/obs.py``), less ``base``."""
    now = {"K1": obs.counter("k1.launches"), "K3": obs.counter("k3.launches")}
    return now if base is None else {k: n - base[k] for k, n in now.items()}


def device_ms(calls, reps: int = REPS, warmup: int = 1):
    """→ (the device's own time of each ``(fn, n, match)`` in ``calls``,
    what the first trace lacked or None).  The time, in ms, is the median
    over ``reps`` calls of the summed durations of the
    kernels (or copies) whose names hold ``match`` that one ``fn()``
    launches, from one ``torch.profiler`` trace over every call, each
    call in a ``record_function`` range of its own that its launches are
    matched to (``util/obs.py`` ``trace_device_ranges``).  ``n`` is the
    count of such launches a call makes (None: what the kernels' wrappers
    count in one warm-up call); a call whose records in the trace do not
    number ``n`` raises.  ``event_ms``'s window holds the wrapper's host
    time as well; this holds only the device's.  A trace short of kernels
    is taken once more (``traced``); the first try's loss is returned for
    the caller's line, so that a time from a retaken trace shows there."""
    from torch.profiler import record_function

    from strawboat_tpu_torch.util.obs import trace_device_ranges

    counts = []
    for fn, n, _match in calls:
        before = kernel_launches()
        for _ in range(warmup):
            fn()
        counts.append(n if n is not None else (kernel_launches() - before) // warmup)
    def run():
        for i, (fn, _n, _match) in enumerate(calls):
            for r in range(reps):
                with record_function(f"sb_call_{i}_{r}"):
                    fn()

    with tempfile.TemporaryDirectory() as logdir:
        tr, _, first = traced(logdir, "cuda", "device_ms", run)
        ranges = trace_device_ranges(tr.path, "sb_call_")
    out = []
    for i, ((_fn, _n, match), n) in enumerate(zip(calls, counts)):
        durs = [[d for name, d in ranges.get(f"sb_call_{i}_{r}", ()) if match in name]
                for r in range(reps)]
        short = [r for r, d in enumerate(durs) if len(d) != n]
        if short:
            raise AssertionError(f"call {i} of {len(calls)}: reps {short} lack their {n} "
                                 f"{match!r} records in the trace")
        out.append(statistics.median([sum(d) for d in durs]) * 1e3)
    return out, first


def kernel_ms(path: str, top: int = 8) -> dict:
    """The ``top`` longest kernels that ran inside a ``device_trace``
    window, by name (its first 120 characters): summed device ms and
    count (the trace's lead-in before the window is left out)."""
    from strawboat_tpu_torch.util.obs import _TRACE_SPAN

    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    span = next(e for e in events if e.get("name") == _TRACE_SPAN and e.get("cat") == "user_annotation")
    lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    by = {}
    for e in events:
        if e.get("cat") == "kernel" and lo <= float(e["ts"]) <= hi:
            ms, n = by.get(e["name"][:120], (0.0, 0))
            by[e["name"][:120]] = (ms + float(e.get("dur", 0)) * 1e-3, n + 1)
    return {k: {"ms": ms, "n": n}
            for k, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:top]}


@contextlib.contextmanager
def k1_plane_tiles():
    """Tallies the planes the paths hand K1 (every K1 call of the port goes
    through ``exec/resident.py``): ``{"planes_by_tiles": {n_tiles: planes},
    "lone_one_tile_calls": calls of 1-tile planes alone}``."""
    from strawboat_tpu_torch.exec import resident

    tally = {"planes_by_tiles": {}, "lone_one_tile_calls": 0}
    one, many = resident.bitunpack_tiled, resident.bitunpack_tiled_many

    def seen(shapes):
        for w in shapes:
            tally["planes_by_tiles"][w.shape[0]] = tally["planes_by_tiles"].get(w.shape[0], 0) + 1
        if shapes and all(w.shape[0] == 1 for w in shapes):
            tally["lone_one_tile_calls"] += 1

    def one_seen(w, seed, b):
        seen([w])
        return one(w, seed, b)

    def many_seen(planes, seed=0):
        planes = list(planes)
        seen([w for w, _b in planes])
        return many(planes, seed)

    resident.bitunpack_tiled, resident.bitunpack_tiled_many = one_seen, many_seen
    try:
        yield tally
    finally:
        resident.bitunpack_tiled, resident.bitunpack_tiled_many = one, many


@contextlib.contextmanager
def k1_a_launch_a_plane():
    """The resident callers' K1 calls as the parent made them: a launch a
    plane through ``bitunpack_tiled``, not one ``bitunpack_tiled_many``."""
    from strawboat_tpu_torch.exec import resident
    from strawboat_tpu_torch.kernels import bitunpack as bu

    many = resident.bitunpack_tiled_many
    resident.bitunpack_tiled_many = lambda planes, seed=0: [
        bu.bitunpack_tiled(w, seed, b) for w, b in planes]
    try:
        yield
    finally:
        resident.bitunpack_tiled_many = many


def phase_k1_batching(rt, srt) -> dict:
    """Resident Q6, Q1 and the sharded Q6, warm, with their planes in one
    K1 call and a launch a plane, in turns (one, per plane, per plane,
    one): what the batching alone moves end to end."""
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.benchsuite import tpch

    out = {}
    for name, run in (("q6", lambda: int(tpch.q6(rt))), ("q1", lambda: tpch.q1(rt)),
                      ("sharded_q6", lambda: par.sharded_filter_sum(srt, *Q6_FILTER_SUM).item())):
        ms = {"one_call_ms": [], "per_plane_ms": []}
        for key in ("one_call_ms", "per_plane_ms", "per_plane_ms", "one_call_ms"):
            with k1_a_launch_a_plane() if key == "per_plane_ms" else contextlib.nullcontext():
                ms[key].append(wall_ms(run))
        out[name] = {k: statistics.mean(v) for k, v in ms.items()} | {"turns": ms}
    emit("k1_batching", **out)
    return out


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


def k1_bytes(planes) -> int:
    """What K1 must move over ``planes`` [(words, bits)]: b words in and
    32 out per lane column."""
    return sum(w.numel() * 4 * (b + 32) // b for w, b in planes)


def _k1_many_equal(what: str, planes) -> int:
    """``bitunpack_tiled_many(planes)`` == the plain version of every
    plane (else it raises); returns the launches it made."""
    from strawboat_tpu_torch.kernels import bitunpack as bu

    before = k1_counts()
    got = bu.bitunpack_tiled_many(planes)
    torch.cuda.synchronize()
    launched, _planes = k1_counts(before)
    for i, ((w, b), g) in enumerate(zip(planes, got)):
        if not torch.equal(g, bu.bitunpack_tiled_plain(w, 0, b)):
            raise AssertionError(f"{what} disagree with plain: plane {i} of {len(planes)}, "
                                 f"{tuple(w.shape)}")
    return launched


def _k1_many_checks(rng, device) -> dict:
    """``bitunpack_tiled_many`` == the plain version: widths 1..32 at tiles
    16384 and 512 (64 planes, one launch) under both seeds, 70 planes (two
    launches), and an odd tile and a base 4 bytes past 16 (the kernel's
    scalar path) among aligned planes."""
    from strawboat_tpu_torch.kernels import bitunpack as bu

    def check(what, planes, seed, launches):
        before = (obs.counter("k1.launches"), obs.counter("k1.planes"))
        got = bu.bitunpack_tiled_many(planes, seed)
        torch.cuda.synchronize()
        moved = (obs.counter("k1.launches") - before[0], obs.counter("k1.planes") - before[1])
        if moved != (launches, len(planes)):
            raise AssertionError(f"K1 many {what}: launches, planes {moved} != {launches, len(planes)}")
        for i, ((w, b), g) in enumerate(zip(planes, got)):
            if not torch.equal(g, bu.bitunpack_tiled_plain(w, seed, b)):
                raise AssertionError(f"K1 many {what} disagrees with plain: plane {i} b={b}")

    mixed = [(random_words(rng, 3, b, tile, device), b) for tile in (bu.TILE3D, 512)
             for b in range(1, 33)]
    for s in SEEDS:
        check("widths 1..32, tiles 16384 and 512", mixed, s, 1)
    check("past the cap", mixed + mixed[:6], SEEDS[1], 2)
    flat = random_words(rng, 1, 1, 4 + 2 * 7 * 1000, device).reshape(-1)
    odd = [(random_words(rng, 2, 5, 1001, device), 5), mixed[10],
           (flat[1 : 1 + 2 * 7 * 1000].view(2, 7, 1000), 7), mixed[40]]
    check("odd tile, base off 16 bytes", odd, SEEDS[1], 1)
    return {"mixed_planes": len(mixed), "past_cap_planes": len(mixed) + 6,
            "odd": [[tuple(w.shape), w.data_ptr() % 16] for w, _b in odd]}


def phase_kernel(device, seed: int, tile: int) -> dict:
    """K1 vs its plain version: every width and seed at (8, b, tile), the
    many-plane entry over mixed lists; then K1's times at the path's
    shapes and plane groups, by CUDA events and by the profiler, against
    the bound and a same-window ``copy_`` of the same bytes.  Returns the
    kernel summary."""
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
    many = _k1_many_checks(rng, device)

    # shapes: (n_tiles, b) at the path's widths; groups: the planes of
    # resident Q6 and Q1 (SF10) and of the sharded Q6 (every shard's)
    shapes = {(n, b): random_words(rng, n, b, tile, device) for n in K1_TILES for b in PATH_WIDTHS}
    for (n, b), w in shapes.items():
        if not torch.equal(bu.bitunpack_tiled(w, 0, b), bu.bitunpack_tiled_plain(w, 0, b)):
            raise AssertionError(f"K1 disagrees with plain at ({n}, {b}, {tile})")
    groups = {
        "q6": [(random_words(rng, SF10_TILES, COLUMN_WIDTHS[c], tile, device), COLUMN_WIDTHS[c])
               for c in Q6_COLUMNS],
        "q1": [(random_words(rng, SF10_TILES, b, tile, device), b)
               for b in COLUMN_WIDTHS.values()],
        "sharded_q6": [(random_words(rng, K1_TILES[1], COLUMN_WIDTHS[c], tile, device),
                        COLUMN_WIDTHS[c]) for _s in range(MULTI_SHARDS) for c in Q6_COLUMNS],
    }
    copies = {}

    def copy_of(nbytes):
        if nbytes not in copies:
            half = torch.empty(nbytes // 8, dtype=torch.int32, device=device)
            copies[nbytes] = (half, torch.ones_like(half))
        dst, src = copies[nbytes]
        return lambda: dst.copy_(src)

    calls, times = [], {}
    for (n, b), w in shapes.items():
        nbytes = k1_bytes([(w, b)])
        times[f"{n}x{b}"] = {
            "ms": event_ms(lambda w=w, b=b: bu.bitunpack_tiled(w, 0, b)),
            "bound_ms": bound_ms(nbytes)}
        if n == SF10_TILES:
            times[f"{n}x{b}"]["plain_ms"] = event_ms(lambda w=w, b=b: bu.bitunpack_tiled_plain(w, 0, b))
        calls += [(lambda w=w, b=b: bu.bitunpack_tiled(w, 0, b), None, "bitunpack"),
                  (copy_of(nbytes), 1, "Memcpy")]
    for name, planes in groups.items():
        nbytes = k1_bytes(planes)
        n_launches = _k1_many_equal(f"K1 {name} planes", planes)
        times[name] = {
            "planes": len(planes), "launches": n_launches, "bound_ms": bound_ms(nbytes),
            "ms": event_ms(lambda p=planes: bu.bitunpack_tiled_many(p)),
            "per_plane_ms": event_ms(lambda p=planes: [bu.bitunpack_tiled(w, 0, b) for w, b in p])}
        calls += [(lambda p=planes: bu.bitunpack_tiled_many(p), None, "bitunpack"),
                  (lambda p=planes: [bu.bitunpack_tiled(w, 0, b) for w, b in p], None,
                   "bitunpack"),
                  (copy_of(nbytes), 1, "Memcpy")]
    dev, first = device_ms(calls)
    dev = iter(dev)
    for key, t in times.items():
        t["device_ms"] = next(dev)
        if "per_plane_ms" in t:
            t["per_plane_device_ms"] = next(dev)
        t["copy_device_ms"] = next(dev)
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        t["TB_per_s"] = t["bound_share"] * HBM_BYTES_PER_S / 1e12
    emit("kernel", widths_checked=32, seeds=[hex(s) for s in SEEDS], max_abs_err=max_err,
         many=many, tile=tile, times=times, device_ms_first_try_short=first)
    del shapes, groups, copies
    torch.cuda.empty_cache()
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
    widths = {n: c["bits"] for n, c in planes.items()}
    if widths != {n: [b] for n, b in COLUMN_WIDTHS.items()}:
        raise AssertionError(f"plane widths {widths} != the kernel phase's {COLUMN_WIDTHS}")
    emit("load", rows=rt.num_rows, tile=rt.tile, load_s=load_s, planes=planes,
         plane_bytes=sum(p["bytes"] for p in planes.values()),
         memory_allocated=torch.cuda.memory_allocated(),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return rt


def k1_counts(before=(0, 0)) -> tuple:
    """K1's (launches, planes) counts, less ``before``."""
    return (obs.counter("k1.launches") - before[0], obs.counter("k1.planes") - before[1])


def phase_q6(rt, cols) -> None:
    from strawboat_tpu_torch.benchsuite import tpch

    before = k1_counts()
    k7 = (obs.counter("k7.launches"), obs.counter("k7.torch_routes"))
    got = int(tpch.q6(rt))
    launched, planes = k1_counts(before)
    k7 = (obs.counter("k7.launches") - k7[0], obs.counter("k7.torch_routes") - k7[1])
    want = tpch.q6_numpy_reference(cols)
    if got != want:
        raise AssertionError(f"Q6 {got} != numpy {want}")
    if launched != 1:
        raise AssertionError(f"Q6 launched K1 {launched} times, not once")
    if k7 != (1, 0):
        raise AssertionError(f"Q6: K7 launches, filter_sums on the torch route {k7} != (1, 0)")
    ms = wall_ms(lambda: int(tpch.q6(rt)))
    emit("q6", revenue=got, equal_to_numpy=True, k1_launches=launched, k1_planes=planes,
         k7_launches=k7[0], k7_torch_routes=k7[1], warm_median_ms=ms)


def _q1_check(what: str, got, want) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{what}: groups {list(got)} != numpy {list(want)}")
    for key, aggs in want.items():
        for name, w in aggs.items():
            g = got[key][name]
            if name.startswith("avg_"):
                np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=f"{what} {key} {name}")
            elif g != w:
                raise AssertionError(f"{what} {key} {name}: {g} != numpy {w}")


def phase_q1(rt, cols) -> None:
    from strawboat_tpu_torch.benchsuite import tpch

    before = k1_counts()
    k6 = (obs.counter("k6.launches"), obs.counter("k6.torch_aggs"))
    res = tpch.q1(rt)
    launched, planes = k1_counts(before)
    k6 = (obs.counter("k6.launches") - k6[0], obs.counter("k6.torch_aggs") - k6[1])
    got = tpch.q1_rows(res)
    _q1_check("Q1", got, tpch.q1_numpy_reference(cols))
    if launched != 1:
        raise AssertionError(f"Q1 launched K1 {launched} times, not once")
    if k6 != (1, 0):
        raise AssertionError(f"Q1: K6 launches, aggregates on the torch route {k6} != (1, 0)")
    ms = wall_ms(lambda: tpch.q1(rt))
    emit("q1", groups=len(got), equal_to_numpy=True, k1_launches=launched, k1_planes=planes,
         k6_launches=k6[0], k6_torch_aggs=k6[1], warm_median_ms=ms,
         count_order=sum(a["count_order"] for a in got.values()))


def phase_k6(rt) -> dict:
    """K6 on the call resident Q1 makes (captured from one ``tpch.q1``):
    equal to its plain version, one launch a call, its times against the
    bound.  Returns the kernel summary."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import aggregate
    from strawboat_tpu_torch.kernels import group_agg as ga

    seen, orig = [], aggregate.group_agg

    def capture(*a):
        seen.append(a)
        return orig(*a)

    aggregate.group_agg = capture
    try:
        tpch.q1(rt)
    finally:
        aggregate.group_agg = orig
    if len(seen) != 1:
        raise AssertionError(f"resident Q1 called K6 {len(seen)} times, not once")
    keys, cap, mask, outputs = seen[0]
    before = obs.counter("k6.launches")
    got = ga.group_agg(keys, cap, mask, outputs)
    want = ga.group_agg_plain(keys, cap, mask, outputs)
    torch.cuda.synchronize()
    launches = obs.counter("k6.launches") - before
    if launches != 1 or not torch.equal(got, want):
        raise AssertionError(f"K6 on Q1's inputs: {launches} launches, equal {torch.equal(got, want)}")
    # each distinct input read once, the sums written once
    inputs = {t.data_ptr(): t for t in [k for k, _s in keys] + [mask]
              + [t for o in outputs for t in o if t is not None]}
    nbytes = sum(t.numel() * t.element_size() for t in inputs.values()) + got.numel() * 8
    distinct = len({(id(v), id(m)) for v, m in outputs})
    facts = {"max_abs_err": 0, "rows": int(mask.shape[0]), "cap": cap, "keys": len(keys),
             "outputs": len(outputs), "distinct_outputs": distinct,
             "plan": ga.plan_launches(cap, distinct), "input_bytes": nbytes,
             "bound_ms": bound_ms(nbytes),
             "ms": event_ms(lambda: ga.group_agg(keys, cap, mask, outputs)),
             "plain_ms": event_ms(lambda: ga.group_agg_plain(keys, cap, mask, outputs), 3, 1)}
    dev, facts["device_ms_first_try_short"] = device_ms(
        [(lambda: ga.group_agg(keys, cap, mask, outputs), 1, "group_agg")])
    facts["device_ms"] = dev[0]
    facts["bound_share"] = facts["bound_ms"] / facts["device_ms"]
    emit("k6", launches_a_call=launches, equal_to_plain=True, **facts)
    return facts


def phase_k7(rt) -> dict:
    """K7 on the call resident Q6 makes (captured from one ``tpch.q6``):
    equal to its plain version, one launch a call, its times against the
    bound.  Returns the kernel summary."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import resident
    from strawboat_tpu_torch.kernels import filter_sum as fs

    seen, orig = [], resident.k7_filter_sum

    def capture(*a):
        seen.append(a)
        return orig(*a)

    resident.k7_filter_sum = capture
    try:
        tpch.q6(rt)
    finally:
        resident.k7_filter_sum = orig
    if len(seen) != 1:
        raise AssertionError(f"resident Q6 called K7 {len(seen)} times, not once")
    args = seen[0]
    value, rows, product, bounds, nonzero = args
    before = obs.counter("k7.launches")
    got = fs.filter_sum(*args)
    want = fs.filter_sum_plain(*args)
    torch.cuda.synchronize()
    launches = obs.counter("k7.launches") - before
    if launches != 1 or not torch.equal(got, want):
        raise AssertionError(f"K7 on Q6's inputs: {launches} launches, equal {torch.equal(got, want)}")
    # each distinct input's rows read once (the padding slots are not read),
    # the sum written once
    inputs = {t.data_ptr(): t for t in [value, product, *(b[0] for b in bounds), *nonzero]
              if t is not None}
    nbytes = len(inputs) * rows * 4 + 8
    facts = {"max_abs_err": 0, "rows": rows, "slots": int(value.shape[0]),
             "inputs": len(inputs), "bounds": [b[1:] for b in bounds], "input_bytes": nbytes,
             "bound_ms": bound_ms(nbytes),
             "slot_bound_ms": bound_ms(len(inputs) * int(value.shape[0]) * 4),
             "ms": event_ms(lambda: fs.filter_sum(*args)),
             "plain_ms": event_ms(lambda: fs.filter_sum_plain(*args), 3, 1)}
    dev, facts["device_ms_first_try_short"] = device_ms(
        [(lambda: fs.filter_sum(*args), 1, "filter_sum")])
    facts["device_ms"] = dev[0]
    facts["bound_share"] = facts["bound_ms"] / facts["device_ms"]
    emit("k7", launches_a_call=launches, equal_to_plain=True, **facts)
    return facts


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
            "STRAWBOAT_RLE_COMPRESSION", "STRAWBOAT_FREQ_COMPRESSION",
            "STRAWBOAT_PATAS_COMPRESSION")
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
            metas = tpch.write_lineitem(path, cols, max_page_size=PAGE_ROWS,
                                        columns=tpch.INT_COLUMNS)
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

    tables = {}
    facts = {}
    for name, path in paths.items():
        before = obs.counter("k3.launches")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        table = scan_file(path, device=device)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launched = obs.counter("k3.launches") - before
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


def _check_equal(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got} != numpy {want}")


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _q3_checks(li_path, o_path, cols, orders, device) -> dict:
    """The Q3-shaped join through the Query API over the two files, and
    through ``q3_like`` over their scans; both equal numpy."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import scan_file

    t0 = time.perf_counter()
    want = tpch.q3_numpy_reference(cols, orders)
    numpy_s = time.perf_counter() - t0

    def query():
        res = tpch.q3_query(li_path, o_path, device)
        return tpch.q3_rows(res["key_o_orderpriority"], res["n_groups"], res["revenue"])

    _check_equal("Q3 through Query", query(), want)
    query_ms = wall_ms(query, reps=SCAN_REPS)
    lt, ot = scan_file(li_path, device), scan_file(o_path, device)
    _check_equal("q3_like over the scans", tpch.q3_rows(*tpch.q3_like(lt, ot)), want)
    like_ms = event_ms(lambda: tpch.q3_like(lt, ot), reps=5, warmup=1)
    return {"groups": want, "equal_to_numpy": True, "numpy_s": numpy_s,
            "query_warm_median_ms": query_ms, "q3_like_device_ms": like_ms}


def _suppkey_check(li_path, cols, device) -> dict:
    """Group by l_suppkey (not a dictionary column; 10 000 groups, so the
    capacity grows from 4096), then ORDER BY revenue DESC LIMIT 10."""
    from strawboat_tpu_torch.exec import Query, aggregate, col

    def query():
        return (Query(li_path, device=device)
                .filter(col("l_shipdate") <= 2467)
                .group_by("l_suppkey", num_groups=4096)
                .agg(revenue=("sum", col("l_extendedprice") * (100 - col("l_discount"))),
                     min_qty=("min", "l_quantity"), max_qty=("max", "l_quantity"),
                     avg_price=("avg", "l_extendedprice"), n=("count", "l_quantity"))
                .order_by(("revenue", "desc"))
                .limit(10)
                .run())

    # count hash_aggregate's passes and the capacity of the last one
    runs = []
    inner = aggregate.grouped_aggregate
    aggregate.grouped_aggregate = lambda *a, **k: runs.append(a[3]) or inner(*a, **k)
    try:
        res = query()
    finally:
        aggregate.grouped_aggregate = inner
    m = cols["l_shipdate"] <= 2467
    sk = cols["l_suppkey"][m]
    qty, price, disc = cols["l_quantity"][m], cols["l_extendedprice"][m], cols["l_discount"][m]
    n_keys = int(cols["l_suppkey"].max()) + 1
    rev_f = np.bincount(sk, weights=price * (100 - disc), minlength=n_keys)
    if rev_f.max() >= 2**53:
        raise AssertionError("revenue per supplier beyond float64's exact integers")
    rev = rev_f.astype(np.int64)
    cnt = np.bincount(sk, minlength=n_keys)
    present = np.bincount(sk * 51 + qty, minlength=n_keys * 51).reshape(n_keys, 51) > 0
    live = np.flatnonzero(cnt)
    top = live[np.argsort(-rev[live], kind="stable")[:10]]
    got = {k: _host(res[k]) for k in ("key_l_suppkey", "revenue", "min_qty", "max_qty", "n",
                                      "avg_price", "taken_valid")}
    _check_equal("suppkey group count", len(live), 10_000)
    _check_equal("suppkey top-10 keys", got["key_l_suppkey"].tolist(), top.tolist())
    _check_equal("suppkey revenue", got["revenue"].tolist(), rev[top].tolist())
    _check_equal("suppkey count", got["n"].tolist(), cnt[top].tolist())
    _check_equal("suppkey min_qty", got["min_qty"].tolist(), present[top].argmax(1).tolist())
    _check_equal("suppkey max_qty", got["max_qty"].tolist(), (50 - present[top, ::-1].argmax(1)).tolist())
    sums = np.bincount(sk, weights=price, minlength=n_keys)[top]
    np.testing.assert_allclose(got["avg_price"], sums / cnt[top], rtol=1e-12)
    if not got["taken_valid"].all() or int(res["n_groups"]) != 10:
        raise AssertionError("suppkey LIMIT 10 took an empty slot")
    return {"groups": int(len(live)), "runs": len(runs), "capacities": runs,
            "equal_to_numpy": True, "warm_median_ms": wall_ms(query, reps=SCAN_REPS)}


def _topk_checks(li_path, cols, device) -> dict:
    """select + ORDER BY l_extendedprice DESC + LIMIT 100, without a filter
    (the single-column branch) and with one (masked); ties keep row order,
    as a stable numpy argsort of the negated key does."""
    from strawboat_tpu_torch.exec import Query, col
    from strawboat_tpu_torch.exec.scan import host_values

    price = cols["l_extendedprice"]
    out = {}
    for name, pred in (("no_filter", None), ("filter", col("l_shipdate") <= 2467)):
        def query(pred=pred):
            q = Query(li_path, device=device).select("l_orderkey", "l_extendedprice")
            if pred is not None:
                q = q.filter(pred)
            return q.order_by(("l_extendedprice", "desc")).limit(100).run()

        table, taken = query()
        rows = np.arange(len(price)) if pred is None else np.flatnonzero(cols["l_shipdate"] <= 2467)
        # the 100 largest, ties in row order: a stable argsort of the candidates
        thr = np.partition(price[rows], len(rows) - 100)[len(rows) - 100]
        cand = rows[price[rows] >= thr]
        want = cand[np.argsort(-price[cand], kind="stable")[:100]]
        for k in ("l_orderkey", "l_extendedprice"):
            if not np.array_equal(host_values(table[k]), cols[k][want]):
                raise AssertionError(f"top-k {name}: {k} != numpy")
        if taken is not None and not bool(taken.all()):
            raise AssertionError(f"top-k {name} took a masked row")
        out[name] = {"equal_to_numpy": True, "ties_at_cut": int((price[cand] == thr).sum()),
                     "warm_median_ms": wall_ms(query, reps=SCAN_REPS)}
    return out


def _resident_checks(rt, cols) -> dict:
    """Over the resident table: a group-by on l_quantity (plain planes), a
    projection with a limit (natural order), and Q1's aggregates through
    the sort-based hash_aggregate == the fused Q1 == numpy."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import Query, col, hash_aggregate

    if rt["l_quantity"].is_dict:
        raise AssertionError("l_quantity was meant to be plain planes")
    m = cols["l_shipdate"] <= 2467
    res = (Query(rt).filter(col("l_shipdate") <= 2467).group_by("l_quantity", num_groups=64)
           .agg(sum_base=("sum", "l_extendedprice"), n=("count", "l_tax"),
                max_disc=("max", "l_discount")).run())
    n = int(res["n_groups"])
    qty, disc = cols["l_quantity"][m], cols["l_discount"][m]
    keys = _host(res["key_l_quantity"])[:n]
    # per-quantity sums stay below 2^53, so float64 bincount weights are exact
    sums = np.bincount(qty, weights=cols["l_extendedprice"][m]).astype(np.int64)
    present = np.bincount(qty * 11 + disc, minlength=51 * 11).reshape(51, 11) > 0
    _check_equal("resident group keys", keys.tolist(), np.unique(qty).tolist())
    _check_equal("resident group sums", _host(res["sum_base"])[:n].tolist(), sums[keys].tolist())
    _check_equal("resident group counts", _host(res["n"])[:n].tolist(),
                 np.bincount(qty)[keys].tolist())
    _check_equal("resident group max", _host(res["max_disc"])[:n].tolist(),
                 (10 - present[keys, ::-1].argmax(1)).tolist())
    table, _mask = Query(rt).select("l_quantity", "l_extendedprice").filter(
        col("l_discount") > 7).limit(1000).run()
    first = np.flatnonzero(cols["l_discount"] > 7)[:1000]
    for k in ("l_quantity", "l_extendedprice"):
        if not np.array_equal(_host(table[k].values), cols[k][first]):
            raise AssertionError(f"resident projection {k} != numpy")

    def q1_general():
        t, pad = rt.as_device_table(list(tpch.Q1_Q6_COLUMNS))
        mask = pad & (col("l_shipdate") <= tpch.EPOCH_DAYS - tpch.Q1_DEFAULT_DELTA).mask(t)
        r = hash_aggregate(t, ["l_returnflag", "l_linestatus"], tpch.q1_aggs(), num_groups=16, mask=mask)
        k = int(r["n_groups"])
        return {name: _host(r[name][:k]) for name in tpch.Q1_AGG_NAMES}

    general, fused = q1_general(), tpch.q1(rt)
    want = tpch.q1_numpy_reference(cols)
    _check_equal("Q1 groups", (len(general["count_order"]), len(fused["count_order"])),
                 (len(want), len(want)))
    for i, key in enumerate(want):
        for name, w in want[key].items():
            for route, got in (("general", general[name][i]), ("fused", fused[name][i])):
                if name.startswith("avg_"):
                    np.testing.assert_allclose(got, w, rtol=1e-12, err_msg=f"Q1 {route} {key} {name}")
                elif int(got) != w:
                    raise AssertionError(f"Q1 {route} {key} {name}: {got} != numpy {w}")
    return {"group_by_quantity": {"groups": n, "equal_to_numpy": True},
            "projection_limit": {"rows": 1000, "equal_to_numpy": True},
            "q1_general_ms": wall_ms(q1_general), "q1_fused_ms": wall_ms(lambda: tpch.q1(rt)),
            "q1_equal": True}


def _all_planes(c):
    """A resident column's planes, its validity plane and its children's."""
    out = list(c.planes)
    if c.validity_plane is not None:
        out.append((c.validity_plane, 1))
    for sub in ([c.child] if c.child is not None else []) + list((c.children or {}).values()):
        out += _all_planes(sub)
    return out


def _plane_bytes(rt) -> int:
    return sum(w.numel() * 4 for c in rt.columns.values() for w, _b in _all_planes(c))


def _loader_checks(paths, cols, device):
    """load_resident(dict file): planes == make_resident of the numpy
    columns, word for word; make_resident(scan_file(bitpack file)): decoded
    columns == the generated ones.  Q6 over each == numpy.  Returns the
    facts and the make_resident(scan) table, whose device-direct planes K1
    is timed over."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import load_resident, make_resident, scan_file
    from strawboat_tpu_torch.exec.scan import DeviceColumn, host_values

    want_q6 = tpch.q6_numpy_reference(cols)
    ints = {k: cols[k] for k in tpch.INT_COLUMNS}
    out = {}
    t0 = time.perf_counter()
    rt = load_resident(paths["dict"], device)
    torch.cuda.synchronize()
    out["load_resident"] = {"seconds": time.perf_counter() - t0, "plane_bytes": _plane_bytes(rt)}
    ref = make_resident(ints, device)
    for n, c in ref.columns.items():
        mine = rt.columns[n]
        same = (len(mine.planes) == len(c.planes) and mine.offset == c.offset
                and mine.is_dict == c.is_dict
                and all(b == rb and torch.equal(w, rw) for (w, b), (rw, rb) in zip(mine.planes, c.planes)))
        if not same:
            raise AssertionError(f"load_resident column {n}: planes != make_resident of numpy")
    del ref
    _check_equal("Q6 over load_resident", int(tpch.q6(rt)), want_q6)
    out["load_resident"].update(planes_equal=True, q6_equal_to_numpy=True)
    del rt
    t0 = time.perf_counter()
    rt = make_resident(scan_file(paths["bitpack"], device), device)
    torch.cuda.synchronize()
    out["make_resident_scan"] = {"seconds": time.perf_counter() - t0, "plane_bytes": _plane_bytes(rt)}
    for k in tpch.INT_COLUMNS:
        got = host_values(DeviceColumn(k, rt[k].arrow_type, rt.decode_natural(k)))
        if not np.array_equal(got, ints[k]):
            raise AssertionError(f"make_resident(scan) column {k} != the generated column")
    _check_equal("Q6 over make_resident(scan)", int(tpch.q6(rt)), want_q6)
    out["make_resident_scan"].update(decoded_equal=True, q6_equal_to_numpy=True)
    return out, rt


def phase_general(paths, cols, rt, tmpdir, device):
    """The general query path at full width over the SF10 files and the
    resident table; every answer against numpy.  Returns the orders file's
    path and the make_resident(scan) table, so that the kernel summary
    times K3 and K1 over their shapes too."""
    from strawboat_tpu_torch.benchsuite import tpch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    orders = tpch.generate_orders(SF10_ROWS / tpch.ROWS_PER_SF, seed=1)
    o_path = os.path.join(tmpdir, "orders_dict.str")
    gen_s = time.perf_counter() - t0
    with forcing(FILES["dict"]):
        t0 = time.perf_counter()
        tpch.write_orders(o_path, orders, max_page_size=PAGE_ROWS)
    facts = {"orders": {"rows": len(orders["o_orderkey"]), "generate_s": gen_s,
                        "write_s": time.perf_counter() - t0, "bytes": os.path.getsize(o_path)}}
    facts["q3"] = _q3_checks(paths["dict"], o_path, cols, orders, device)
    facts["suppkey"] = _suppkey_check(paths["dict"], cols, device)
    facts["topk"] = _topk_checks(paths["dict"], cols, device)
    facts["resident"] = _resident_checks(rt, cols)
    facts["loaders"], scan_rt = _loader_checks(paths, cols, device)
    emit("general", **facts, max_memory_allocated=torch.cuda.max_memory_allocated())
    return o_path, scan_rt


def _host_column(c) -> np.ndarray:
    """A scanned column on the host: values, or a string column's
    ``dictionary[codes]`` as unicode."""
    from strawboat_tpu_torch.exec.scan import host_values

    vals = host_values(c)
    if c.dictionary is None:
        return vals
    return np.array([v.decode() for v in c.dictionary])[vals]


def phase_lineitem_full(cols, tmpdir, device) -> str:
    """The whole lineitem file: the ten columns (three utf8) written under
    the ``dict`` flags with zone maps, scanned whole, Q6 over a pruned
    scan, Q1 over the file through ``Query``, ``load_resident`` with the
    fused Q1 and Q6; every answer against numpy.  (The same columns under
    no flag, raw pages, are scanned by ``scripts/torch_feed_compare.py``.)
    Returns the dict file's path, whose K3 groups the kernel line times."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import load_resident, scan_file
    from strawboat_tpu_torch.exec.scan import _open, page_keep_mask

    torch.cuda.reset_peak_memory_stats()
    path = os.path.join(tmpdir, "lineitem_full.str")
    with forcing(FILES["dict"]):
        t0 = time.perf_counter()
        metas = tpch.write_lineitem(path, cols, max_page_size=PAGE_ROWS, zone_maps=True)
    facts = {"write": {"seconds": time.perf_counter() - t0, "bytes": os.path.getsize(path),
                       "columns": len(metas), "pages_per_column": len(metas[0].pages)}}

    strings = ("l_returnflag", "l_linestatus", "l_shipmode")
    before = obs.counter("k3.launches")
    table = scan_file(path, device)
    facts["scan"] = {"k3_launches": obs.counter("k3.launches") - before}
    for k in tpch.LINEITEM_COLUMNS:
        if not np.array_equal(_host_column(table[k]), cols[k]):
            raise AssertionError(f"scanned column {k} of the full file != the generated column")
    facts["scan"]["dictionaries"] = {k: [v.decode() for v in table[k].dictionary] for k in strings}
    del table
    before = obs.counter("k3.launches")
    strings_only = scan_file(path, device, columns=strings)
    torch.cuda.synchronize()
    facts["scan"]["k3_launches_string_index_pages"] = obs.counter("k3.launches") - before
    del strings_only
    facts["scan"].update(equal_to_numpy=True, warm_median_ms=wall_ms(
        lambda: scan_file(path, device), reps=SCAN_REPS))

    q6_cols = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
    preds = tpch.q6_pruning_predicates()
    want_q6 = tpch.q6_numpy_reference(cols)
    pruned = scan_file(path, device, columns=q6_cols, predicates=preds)
    _check_equal("Q6 over the pruned scan", int(tpch.q6(pruned)), want_q6)
    keep = page_keep_mask(path, _open(path)[1], preds)
    facts["q6_pruned"] = {
        "pages_kept": int(keep.sum()), "pages": len(keep), "rows_scanned": pruned.num_rows,
        "revenue": want_q6, "equal_to_numpy": True,
        "pruned_warm_median_ms": wall_ms(lambda: int(tpch.q6(scan_file(
            path, device, columns=q6_cols, predicates=preds))), reps=SCAN_REPS),
        "unpruned_warm_median_ms": wall_ms(lambda: int(tpch.q6(scan_file(
            path, device, columns=q6_cols))), reps=SCAN_REPS),
    }
    del pruned

    want_q1 = tpch.q1_numpy_reference(cols)
    _q1_check("Q1 over the file", tpch.q1_rows(tpch.q1_query(path, device)), want_q1)
    facts["q1_query"] = {"groups": len(want_q1), "equal_to_numpy": True,
                         "warm_median_ms": wall_ms(lambda: tpch.q1_rows(tpch.q1_query(path, device)),
                                                   reps=SCAN_REPS)}

    t0 = time.perf_counter()
    rt = load_resident(path, device)
    torch.cuda.synchronize()
    facts["load_resident"] = {"seconds": time.perf_counter() - t0, "plane_bytes": _plane_bytes(rt),
                              "columns": len(rt.columns)}
    _q1_check("fused Q1 over load_resident", tpch.q1_rows(tpch.q1(rt)), want_q1)
    _check_equal("Q6 over load_resident", int(tpch.q6(rt)), want_q6)
    facts["load_resident"].update(q1_equal_to_numpy=True, q6_equal_to_numpy=True)
    del rt
    emit("lineitem_full", rows=SF10_ROWS, page_rows=PAGE_ROWS, flags=FILES["dict"], zone_maps=True,
         **facts, max_memory_allocated=torch.cuda.max_memory_allocated(), nvidia_smi=nvidia_smi())
    return path


def _check_arrow(what: str, arr, want: np.ndarray) -> None:
    """An arrow column of ``read_table`` against the generated numpy
    column (strings through their dictionary encoding)."""
    import pyarrow.compute as pc

    if hasattr(arr, "combine_chunks"):  # a table's column, not a batch's
        arr = arr.combine_chunks()
    if arr.null_count or len(arr) != len(want):
        raise AssertionError(f"{what}: {len(arr)} rows, {arr.null_count} null, want {len(want)}")
    if want.dtype.kind == "U":
        enc = pc.dictionary_encode(arr)
        got = np.array(enc.dictionary.to_pylist())[enc.indices.to_numpy()]
    else:
        got = arr.to_numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"{what} != the generated column")


def phase_file_api(path, cols, tmpdir, device) -> dict:
    """The file-format API over the ``lineitem_full`` file: ``read_table``
    (plain, then twice through one ``ReadArena``: its first read
    allocates, the second recycles), every column of the plain read equal
    to the generated one and every column of each arena read equal to the
    plain read's; ``iter_batches`` over the first
    ``FILE_API_BATCHES`` pages, each batch's columns equal to the
    generated rows; ``stat_simple`` of every column (pages by codec);
    ``scan_file`` on the card with ``to_arrow``, equal to the plain read;
    then a small file of int64 and ``pa.nulls`` through ``NativeWriter``,
    scanned on the card (the null column's tensors there: zeros, validity
    False), through ``Query`` and through ``read_table`` (a null column)."""
    import collections

    import pyarrow as pa

    from strawboat_tpu_torch import api, stat
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import Query, col, scan_file
    from strawboat_tpu_torch.read.fast import ReadArena
    from strawboat_tpu_torch.read.reader import open_readers
    from strawboat_tpu_torch.write import NativeWriter

    facts = {"file_bytes": os.path.getsize(path), "rows": len(cols["l_orderkey"])}
    arena = ReadArena()
    seconds = {}
    for turn, a in (("plain", None), ("arena_first", arena), ("arena_recycled", arena)):
        t0 = time.perf_counter()
        table = api.read_table(path, arena=a)
        seconds[turn] = time.perf_counter() - t0
        # each read checked before the next one recycles the arena's
        # buffers: the plain read against the generated columns, each
        # arena read against the plain read (so against them too; an
        # arrow comparison, where the string columns' check against numpy
        # takes seconds a read at SF10)
        if turn == "plain":
            for k in tpch.LINEITEM_COLUMNS:
                _check_arrow(f"read_table ({turn}) {k}", table[k], cols[k])
            plain = table
        else:
            for k in tpch.LINEITEM_COLUMNS:
                if not table[k].equals(plain[k]):
                    raise AssertionError(f"read_table ({turn}) {k} != the plain read")
        del table
    facts["read_table"] = {"seconds": seconds, "columns_equal_to_generated": True,
                           "arena_buffers": sum(len(b) for b in arena._free.values()) + len(arena._lent)}

    t0 = time.perf_counter()
    rows = batches = 0
    for batch in api.iter_batches(path):
        for k in tpch.LINEITEM_COLUMNS:
            _check_arrow(f"iter_batches batch {batches} {k}", batch.column(k),
                         cols[k][rows : rows + batch.num_rows])
        rows += batch.num_rows
        batches += 1
        if batches == FILE_API_BATCHES:
            break
    facts["iter_batches"] = {"seconds": time.perf_counter() - t0, "batches": batches, "rows": rows,
                             "first_batches_only": FILE_API_BATCHES, "equal_to_generated": True}

    with open(path, "rb") as f:
        schema, metas = api.infer_schema(f), api.read_meta(f)
    t0 = time.perf_counter()
    codecs = {}
    for field, meta in zip(schema, metas):
        (reader,) = open_readers(path, [meta])
        info = stat.stat_simple(reader, field)
        reader.page_reader.close()
        codecs[field.name] = dict(collections.Counter(
            p.body.common.name if p.body.kind == "common" else
            f"dict/{p.body.dict.indices.body.kind}" if p.body.kind == "dict" else p.body.kind
            for p in info.pages))
    facts["stat_simple"] = {"seconds": time.perf_counter() - t0, "pages_by_codec": codecs}

    t0 = time.perf_counter()
    scanned = scan_file(path, device)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    arrow = scanned.to_arrow()
    facts["scan_file"] = {"seconds": scan_s, "to_arrow_seconds": time.perf_counter() - t0 - scan_s}
    del scanned
    if not arrow.select(list(tpch.LINEITEM_COLUMNS)).equals(plain.select(list(tpch.LINEITEM_COLUMNS))):
        raise AssertionError("scan_file(...).to_arrow() != read_table")
    facts["scan_file"]["equal_to_read_table"] = True
    del arrow, plain

    n = 100_000
    a = np.random.default_rng(SEED).integers(-(10**9), 10**9, n)
    null_path = os.path.join(tmpdir, "nulls.str")
    table = pa.table({"a": a, "n": pa.nulls(n)})
    with open(null_path, "wb") as f:
        w = NativeWriter(f, table.schema)
        w.start()
        w.write(table)
        w.finish()
    got = scan_file(null_path, device)
    nc = got["n"]
    if (nc.values.device.type != device.type or nc.validity.device.type != device.type
            or nc.values.dtype != torch.int32 or bool(nc.values.any()) or bool(nc.validity.any())
            or len(nc) != n or not np.array_equal(got["a"].values.cpu().numpy(), a)):
        raise AssertionError("the null file's scan on the card")
    res, mask = Query(null_path, device=device).filter(col("a") > 0).select("a", "n").run()
    kept = res.to_arrow(mask)
    if kept.num_rows != int((a > 0).sum()) or kept["n"].null_count != kept.num_rows:
        raise AssertionError("Query over the null file")
    back = api.read_table(null_path)
    if back.schema.field("n").type != pa.null() or back["n"].null_count != n:
        raise AssertionError("read_table of the null file")
    facts["null_file"] = {"rows": n, "bytes": os.path.getsize(null_path),
                          "device": str(nc.values.device), "query_rows": kept.num_rows,
                          "read_table_type": str(back.schema.field("n").type)}
    emit("file_api", **facts, nvidia_smi=nvidia_smi())
    return facts


def _close(what: str, got, want, exact: bool) -> None:
    """An answer against numpy: equal when ``exact``, else to rtol 1e-12."""
    if exact:
        _check_equal(what, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=what)


def _q1_typed(what: str, got, want, exact: bool) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{what}: groups {list(got)} != numpy {list(want)}")
    for key, aggs in want.items():
        for name, w in aggs.items():
            _close(f"{what} {key} {name}", got[key][name], w,
                   exact and not name.startswith("avg_"))


def _check_columns(what: str, table, want) -> None:
    for k, w in want.items():
        got = _host_column(table[k])
        if (w.dtype.kind != "U" and got.dtype != w.dtype) or not np.array_equal(got, w):
            raise AssertionError(f"{what}: column {k} != the generated column")


def _write_typed(path, cols, flags, money) -> dict:
    from strawboat_tpu_torch.benchsuite import tpch

    with forcing(flags):
        t0 = time.perf_counter()
        tpch.write_lineitem(path, cols, max_page_size=PAGE_ROWS, zone_maps=True, money=money)
    return {"write_s": time.perf_counter() - t0, "bytes": os.path.getsize(path), "flags": flags}


def _timed_scan(path, device, **scan):
    from strawboat_tpu_torch.exec import scan_file

    before = obs.counter("k3.launches")
    t0 = time.perf_counter()
    table = scan_file(path, device, **scan)
    torch.cuda.synchronize()
    return table, time.perf_counter() - t0, obs.counter("k3.launches") - before


def phase_lineitem_typed(cols, tmpdir, device):
    """TPC-H lineitem with its money columns typed, every answer against
    numpy: ``decimal128(15, 2)`` (exact) and float64 (sums to rtol 1e-12),
    then a PATAS column and a bool column.  Returns the two lineitem
    files' paths (their K3 groups join the kernel line) and the resident
    table of the float64 scan (its planes join K1's)."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.exec import arena, load_resident, make_resident
    from strawboat_tpu_torch.write import write_file

    torch.cuda.reset_peak_memory_stats()
    facts = {}
    paths = {}

    # decimal128(15, 2) money under the dict flags: DICT pages, K3 on codes
    money = "decimal"
    typed = tpch.typed_money(cols, money)
    path = paths["lineitem_decimal"] = os.path.join(tmpdir, "lineitem_decimal.str")
    f = facts[money] = _write_typed(path, cols, FILES["dict"], money)
    table, f["scan_s"], f["k3_launches_scan"] = _timed_scan(path, device)
    _check_columns("decimal file", table, typed)
    del table
    want6, want1 = tpch.q6_numpy_reference(cols, money), tpch.q1_numpy_reference(cols, money=money)
    q6_cols = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
    pruned, f["pruned_scan_s"], _ = _timed_scan(path, device, columns=q6_cols,
                                                 predicates=tpch.q6_pruning_predicates())
    _close("decimal Q6 over the pruned scan", int(tpch.q6(pruned, money)), want6, True)
    f["pruned_rows"] = pruned.num_rows
    del pruned
    t0 = time.perf_counter()
    _q1_typed("decimal Q1 over the file", tpch.q1_rows(tpch.q1_query(path, device, money=money)),
              want1, True)
    f["q1_query_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt = load_resident(path, device)
    torch.cuda.synchronize()
    f["load_resident_s"], f["plane_bytes"] = time.perf_counter() - t0, _plane_bytes(rt)
    _q1_typed("decimal fused Q1 over load_resident", tpch.q1_rows(tpch.q1(rt, money=money)),
              want1, True)
    _close("decimal Q6 over load_resident", int(tpch.q6(rt, money)), want6, True)
    f.update(equal_to_numpy=True, revenue_unscaled=want6)
    del rt

    # float64 money under no flag: raw pages through the streamed feed
    money = "float64"
    typed = tpch.typed_money(cols, money)
    path = paths["lineitem_float64"] = os.path.join(tmpdir, "lineitem_float64.str")
    f = facts[money] = _write_typed(path, cols, {}, money)
    table, f["first_scan_s"], f["k3_launches_scan"] = _timed_scan(path, device)
    _check_columns("float64 file", table, typed)
    del table
    table, f["second_scan_s"], _ = _timed_scan(path, device)
    f["pinned_arena_bytes"] = arena.pooled_bytes()
    want6, want1 = tpch.q6_numpy_reference(cols, money), tpch.q1_numpy_reference(cols, money=money)
    _close("float64 Q6 over the scan", float(tpch.q6(table, money)), want6, False)
    _q1_typed("float64 Q1 over the scan", tpch.q1_rows(tpch.q1(table, money=money)), want1, False)
    t0 = time.perf_counter()
    rt = make_resident(table, device)
    torch.cuda.synchronize()
    f["make_resident_s"], f["plane_bytes"] = time.perf_counter() - t0, _plane_bytes(rt)
    f["resident_planes"] = {k: {"kind": c.kind, "dict": c.is_dict, "bits": [b for _w, b in c.planes]}
                            for k, c in rt.columns.items() if k in tpch.MONEY_COLUMNS}
    del table
    _close("float64 resident Q6", float(tpch.q6(rt, money)), want6, False)
    _q1_typed("float64 resident Q1", tpch.q1_rows(tpch.q1(rt, money=money)), want1, False)
    f.update(equal_to_numpy=True, revenue=want6,
             resident_q6_warm_ms=wall_ms(lambda: float(tpch.q6(rt, money))),
             resident_q1_warm_ms=wall_ms(lambda: tpch.q1(rt, money=money)))

    # l_extendedprice under the PATAS flag, l_linestatus == "F" as bool
    extra = {"l_extendedprice": typed["l_extendedprice"], "l_linestatus_f": cols["l_linestatus"] == "F"}
    path = os.path.join(tmpdir, "patas_bool.str")
    with forcing({"STRAWBOAT_PATAS_COMPRESSION": "1"}):
        t0 = time.perf_counter()
        write_file(path, extra, options=WriteOptions(max_page_size=PAGE_ROWS))
    f = facts["patas_bool"] = {"write_s": time.perf_counter() - t0, "bytes": os.path.getsize(path)}
    table, f["scan_s"], _ = _timed_scan(path, device)
    for k, w in extra.items():
        if table[k].values.cpu().numpy().tobytes() != w.tobytes():
            raise AssertionError(f"scanned {k} of the PATAS/bool file != the generated column")
    f.update(equal_to_numpy=True, true_rows=int(table["l_linestatus_f"].values.sum()))
    del table
    os.remove(path)
    emit("lineitem_typed", rows=len(cols["l_orderkey"]), page_rows=PAGE_ROWS, zone_maps=True, **facts,
         max_memory_allocated=torch.cuda.max_memory_allocated(), nvidia_smi=nvidia_smi())
    return paths, rt

def _timed_levels():
    """A timer around the scan's host level work (level expansion, the
    concatenation of the pages' levels, the offsets composition), set on
    the scan module for the block: {"seconds": total}."""
    from strawboat_tpu_torch.exec import scan as scan_mod

    spent = {"seconds": 0.0}
    names = ("read_validity_nested", "_concat_levels", "_compose_offsets")
    saved = {n: getattr(scan_mod, n) for n in names}

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent["seconds"] += time.perf_counter() - t0
        return run

    @contextlib.contextmanager
    def block():
        for n in names:
            setattr(scan_mod, n, timed(saved[n]))
        try:
            yield spent
        finally:
            for n in names:
                setattr(scan_mod, n, saved[n])

    return block()


def _check_nested_scan(table, orders, li, offsets, device, rows=None) -> None:
    """A scan of the nested orders file against numpy: every flat column,
    the composed and stacked offsets (int64), every leaf (l_returnflag as
    ``dictionary[codes]``); ``rows`` (a slice of orders) for a pruned scan."""
    from strawboat_tpu_torch.benchsuite import tpch

    rows = slice(None) if rows is None else rows
    for k, v in orders.items():
        if not np.array_equal(_host_column(table[k]), v[rows]):
            raise AssertionError(f"nested file: column {k} != the generated column")
    offs = offsets[rows.start or 0 : (rows.stop if rows.stop is not None else len(offsets) - 1) + 1]
    lo, hi = int(offs[0]), int(offs[-1])
    want = torch.from_numpy(offs - lo).to(device)
    for k in ("o_lineprices",) + tuple(f"o_lineitems.{leaf}" for leaf in tpch.NESTED_LINEITEM):
        c = table[k]
        if c.offsets.dtype != torch.int64 or not torch.equal(c.offsets, want) \
                or len(c.offsets_stack) != 1 or not torch.equal(c.offsets_stack[0], want):
            raise AssertionError(f"nested file: offsets of {k} != numpy")
        leaf = "l_extendedprice" if k == "o_lineprices" else k.split(".")[1]
        if not np.array_equal(_host_column(c), li[leaf][lo:hi]):
            raise AssertionError(f"nested file: leaf {k} != the generated lineitems")


def phase_nested(tmpdir, device, seed: int = SEED) -> tuple:
    """TPC-H orders with their lineitems nested at SF2.5: 3.75 M orders
    (seed 1, in o_orderdate order), 1–7 lineitems each (seed 0), about
    15 M lineitems; o_lineitems list<struct<…>> and o_lineprices list<int64>.
    Write under the dict flags with zone maps, scan whole twice, Q6 over
    the leaves and list_segment_sum, a scan pruned by o_orderdate, chunks,
    load_resident (list_sum and every leaf through K1), make_resident of
    the scan's list column; every answer against numpy.  Returns the
    file's path and the resident table (their K3 groups and K1 planes join
    the kernel line)."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.exec import load_resident, make_resident, scan_file
    from strawboat_tpu_torch.exec.aggregate import list_segment_sum
    from strawboat_tpu_torch.exec.pruning import Comparison
    from strawboat_tpu_torch.exec.scan import DeviceTable, _open, page_keep_mask, scan_chunks
    from strawboat_tpu_torch.write import write_file

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    orders = tpch.generate_orders(NESTED_ORDERS / 1_500_000, seed=1)
    order = np.argsort(orders["o_orderdate"], kind="stable")  # loaded in date order
    orders = {k: v[order] for k, v in orders.items()}
    lengths = np.random.default_rng(seed).integers(1, 8, NESTED_ORDERS)
    offsets = np.zeros(NESTED_ORDERS + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    li = tpch.generate_lineitem(1.0, seed=seed, rows=int(offsets[-1]))
    cols, fields = tpch.nested_orders(orders, li, offsets)
    facts = {"generate_s": time.perf_counter() - t0, "orders": NESTED_ORDERS,
             "lineitems": int(offsets[-1]), "page_rows": PAGE_ROWS}
    path = os.path.join(tmpdir, "orders_nested.str")
    with forcing(FILES["dict"]):
        t0 = time.perf_counter()
        metas = write_file(path, cols, schema=fields,
                           options=WriteOptions(max_page_size=PAGE_ROWS, zone_maps=True))
    facts["write"] = {"seconds": time.perf_counter() - t0, "bytes": os.path.getsize(path),
                      "leaf_columns": len(metas), "pages_per_column": len(metas[0].pages)}
    del cols

    scans = []
    for i in range(2):  # cold, then warm; the warm table stays for the queries
        before = obs.counter("k3.launches")
        with _timed_levels() as levels:
            t0 = time.perf_counter()
            table = scan_file(path, device)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        scans.append({"seconds": seconds, "level_host_s": levels["seconds"],
                      "k3_launches": obs.counter("k3.launches") - before})
        if i == 0:
            _check_nested_scan(table, orders, li, offsets, device)
            del table
    facts["scan"] = {"runs": scans, "warm_s": scans[1]["seconds"], "equal_to_numpy": True,
                     "decoded_bytes": sum(c.values.numel() * c.values.element_size()
                                          for c in table.columns.values())}

    leaves = DeviceTable({k: table[f"o_lineitems.{k}"] for k in tpch.NESTED_LINEITEM}, 0)
    _check_equal("Q6 over the o_lineitems leaves", int(tpch.q6(leaves)),
                 tpch.q6_numpy_reference({k: v[: offsets[-1]] for k, v in li.items()}))
    lp = table["o_lineprices"]
    want_sums = np.add.reduceat(li["l_extendedprice"][: offsets[-1]], offsets[:-1])
    got = list_segment_sum(lp.values, lp.offsets, len(lp))
    if not np.array_equal(got.cpu().numpy(), want_sums):
        raise AssertionError("list_segment_sum of o_lineprices != numpy")
    facts["queries"] = {"q6_equal_to_numpy": True, "list_segment_sum_equal_to_numpy": True,
                        "list_segment_sum_ms": event_ms(
                            lambda: list_segment_sum(lp.values, lp.offsets, len(lp)), reps=5)}
    del table, leaves, lp

    preds = [Comparison("o_orderdate", "ge", 731), Comparison("o_orderdate", "lt", 1096)]
    keep = page_keep_mask(path, _open(path)[1], preds)
    t0 = time.perf_counter()
    pruned = scan_file(path, device, predicates=preds)
    torch.cuda.synchronize()
    pages = np.flatnonzero(keep)
    if len(pages) == 0 or not np.array_equal(pages, np.arange(pages[0], pages[-1] + 1)):
        raise AssertionError(f"the o_orderdate pages kept are not one run: {pages}")
    rows = slice(int(pages[0]) * PAGE_ROWS, min(int(pages[-1] + 1) * PAGE_ROWS, NESTED_ORDERS))
    _check_nested_scan(pruned, orders, li, offsets, device, rows)
    lp = pruned["o_lineprices"]
    if not np.array_equal(list_segment_sum(lp.values, lp.offsets, len(lp)).cpu().numpy(),
                          want_sums[rows]):
        raise AssertionError("list_segment_sum over the pruned scan != numpy")
    facts["pruned"] = {"pages_kept": int(keep.sum()), "pages": len(keep), "rows": pruned.num_rows,
                       "seconds": time.perf_counter() - t0, "equal_to_numpy": True}
    del pruned, lp

    total, n_chunks = 0, 0
    for chunk in scan_chunks(path, 32, device, columns=["o_lineprices"]):
        c = chunk["o_lineprices"]
        total += int(list_segment_sum(c.values, c.offsets, len(c)).sum())
        n_chunks += 1
    _check_equal("the chunk sums of o_lineprices", total, int(want_sums.sum()))
    facts["chunks"] = {"chunks": n_chunks, "chunk_pages": 32, "equal_to_whole": True}

    t0 = time.perf_counter()
    rt = load_resident(path, device, columns=["o_orderkey", "o_lineprices", "o_lineitems"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    before = obs.counter("k1.launches")
    if not np.array_equal(rt.list_sum("o_lineprices").cpu().numpy(), want_sums):
        raise AssertionError("list_sum(o_lineprices) over load_resident != numpy")
    if obs.counter("k1.launches") == before:
        raise AssertionError("list_sum did not launch K1")
    item = rt["o_lineitems"].child.children
    for k in tpch.NESTED_LINEITEM:
        got = rt._natural(item[k]).cpu().numpy()
        if item[k].kind == "str":
            got = item[k].dictionary_host[got].astype(str)
        if not np.array_equal(got, li[k][: offsets[-1]]):
            raise AssertionError(f"leaf {k} decoded from its resident planes != the generated one")
    facts["load_resident"] = {
        "seconds": load_s, "plane_bytes": _plane_bytes(rt), "leaves_equal": True,
        "list_sum_equal_to_numpy": True,
        "list_sum_ms": event_ms(lambda: rt.list_sum("o_lineprices"), reps=5)}

    scanned = scan_file(path, device, columns=["o_lineprices"])
    t0 = time.perf_counter()
    rt2 = make_resident(scanned, device)
    torch.cuda.synchronize()
    if not np.array_equal(rt2.list_sum("o_lineprices").cpu().numpy(), want_sums):
        raise AssertionError("list_sum over make_resident(scan) != numpy")
    facts["make_resident_scan"] = {"seconds": time.perf_counter() - t0, "list_sum_equal_to_numpy": True}
    del scanned, rt2
    emit("nested", **facts, max_memory_allocated=torch.cuda.max_memory_allocated(),
         nvidia_smi=nvidia_smi())
    return path, rt


@contextlib.contextmanager
def _codec_tally():
    """Count the codec choices the port logs in the block: {"family:codec":
    pages}."""
    import collections
    import logging

    tally = collections.Counter()

    class Tally(logging.Handler):
        def emit(self, record):
            family, codec = record.args
            tally[f"{family}:{codec}"] += 1

    log = logging.getLogger("strawboat_tpu_torch")
    handler, level = Tally(logging.INFO), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        yield tally
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def _page_codecs(path) -> dict:
    """Each flat column's pages by codec, from their headers."""
    import collections

    from strawboat_tpu_torch.codecs import read_header
    from strawboat_tpu_torch.exec.scan import _open, _plan_pages

    schema, metas, buf = _open(path)
    return {f.name: dict(collections.Counter(read_header(b, p)[0].name
                                             for _l, _v, b, p in _plan_pages(buf, m, f.nullable)))
            for f, m in zip(schema, metas)}


@contextlib.contextmanager
def _timed_stats():
    """A timer around the device writer's stats reductions (synchronized,
    so the device time is inside it): {"seconds": total}."""
    from strawboat_tpu_torch.write import device as device_writer

    spent = {"seconds": 0.0}
    names = ("paged_stats_device", "paged_bool_stats_device")
    saved = {n: getattr(device_writer, n) for n in names}

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent["seconds"] += time.perf_counter() - t0
            return out
        return run

    for n in names:
        setattr(device_writer, n, timed(saved[n]))
    try:
        yield spent
    finally:
        for n in names:
            setattr(device_writer, n, saved[n])


def _pages_rows(keep, n_rows: int) -> np.ndarray:
    """The row indices of the kept pages of a PAGE_ROWS grid."""
    return np.concatenate([np.arange(i * PAGE_ROWS, min((i + 1) * PAGE_ROWS, n_rows))
                           for i in np.flatnonzero(keep)])


def phase_adaptive(cols, tmpdir, device) -> dict:
    """The adaptive write path: ``write_file`` with the JAX
    benchmark's options, two whole scans, Q6 pruned and Q1 over the file,
    then ``write_device_table`` of the scan ordered by l_suppkey on the
    card, rescanned whole and pruned; every answer against numpy.  Returns
    the two files' paths, whose K3 groups the kernel line times."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import scan_file
    from strawboat_tpu_torch.exec.pruning import Comparison
    from strawboat_tpu_torch.exec.scan import DeviceColumn, DeviceTable, _open, page_keep_mask
    from strawboat_tpu_torch.write.device import write_device_table

    torch.cuda.reset_peak_memory_stats()
    # bench.py's TPC-H write options
    opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                        max_page_size=PAGE_ROWS, sample_seed=3, zone_maps=True)
    paths = {"lineitem_adaptive": os.path.join(tmpdir, "lineitem_adaptive.str"),
             "lineitem_device": os.path.join(tmpdir, "lineitem_device.str")}
    path, path2 = paths.values()
    with forcing({}), _codec_tally() as tally:
        t0 = time.perf_counter()
        tpch.write_lineitem(path, cols, options=opts)
    facts = {"write": {"seconds": time.perf_counter() - t0, "bytes": os.path.getsize(path),
                       "codecs_chosen": dict(tally),
                       "page_codecs": _page_codecs(path)}}

    runs = []
    for i in range(2):  # cold, then warm; the warm table stays for the re-encode
        before = obs.counter("k3.launches")
        t0 = time.perf_counter()
        table = scan_file(path, device)
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0,
                     "k3_launches": obs.counter("k3.launches") - before})
        if i == 0:
            _check_columns("adaptive file", table, {k: cols[k] for k in tpch.LINEITEM_COLUMNS})
            del table
    if min(r["k3_launches"] for r in runs) <= 0:
        raise AssertionError(f"the scans of the adaptive file did not launch K3: {runs}")
    facts["scan"] = {"runs": runs, "warm_s": runs[1]["seconds"], "equal_to_numpy": True}

    q6_cols = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
    preds = tpch.q6_pruning_predicates()
    pruned = scan_file(path, device, columns=q6_cols, predicates=preds)
    _check_equal("Q6 over the pruned adaptive scan", int(tpch.q6(pruned)),
                 tpch.q6_numpy_reference(cols))
    keep = page_keep_mask(path, _open(path)[1], preds)
    facts["q6_pruned"] = {"pages_kept": int(keep.sum()), "pages": len(keep),
                          "rows_scanned": pruned.num_rows, "equal_to_numpy": True}
    del pruned
    _q1_check("Q1 over the adaptive file", tpch.q1_rows(tpch.q1_query(path, device)),
              tpch.q1_numpy_reference(cols))
    facts["q1_query"] = {"equal_to_numpy": True}

    # the re-encode: rows ordered by l_suppkey on the card, written again
    order = torch.argsort(table["l_suppkey"].values, stable=True)
    ordered = DeviceTable({k: DeviceColumn(k, c.dtype, c.values[order],
                                           None if c.validity is None else c.validity[order],
                                           c.dictionary)
                           for k, c in table.columns.items()}, table.num_rows)
    torch.cuda.synchronize()
    del table, order
    with _codec_tally() as tally, _timed_stats() as stats:
        t0 = time.perf_counter()
        write_device_table(path2, ordered, opts)
        seconds = time.perf_counter() - t0
    facts["device_write"] = {"seconds": seconds, "bytes": os.path.getsize(path2),
                             "stats_on_card_s": stats["seconds"],
                             "host_encode_s": seconds - stats["seconds"],
                             "codecs_chosen": dict(tally), "page_codecs": _page_codecs(path2)}
    max_memory = torch.cuda.max_memory_allocated()
    del ordered

    perm = np.argsort(cols["l_suppkey"], kind="stable")
    want = {k: cols[k][perm] for k in tpch.LINEITEM_COLUMNS}
    before = obs.counter("k3.launches")
    t0 = time.perf_counter()
    table = scan_file(path2, device)
    torch.cuda.synchronize()
    launched = obs.counter("k3.launches") - before
    if launched <= 0:
        raise AssertionError("the scan of the device-written file did not launch K3")
    _check_columns("device-written file", table, want)
    facts["rescan"] = {"seconds": time.perf_counter() - t0, "k3_launches": launched,
                       "equal_to_numpy": True}
    del table
    preds = [Comparison("l_suppkey", "lt", 1000)]
    keep = page_keep_mask(path2, _open(path2)[1], preds)
    pruned = scan_file(path2, device, predicates=preds)
    rows = _pages_rows(keep, len(perm))
    _check_columns("pruned scan of the device-written file", pruned,
                   {k: v[rows] for k, v in want.items()})
    if not (want["l_suppkey"][rows] < 1000).sum() == (cols["l_suppkey"] < 1000).sum():
        raise AssertionError("the pruned scan lost rows with l_suppkey < 1000")
    facts["rescan_pruned"] = {"pages_kept": int(keep.sum()), "pages": len(keep),
                              "rows_scanned": pruned.num_rows, "equal_to_numpy": True}
    del pruned
    emit("adaptive", rows=len(perm), page_rows=PAGE_ROWS, options="LZ4, ratio 1.0, sample_seed 3",
         **facts, max_memory_allocated=max_memory, nvidia_smi=nvidia_smi())
    return paths


def _same_planes(what: str, got, want) -> None:
    """Two resident tables equal column for column, word for word."""
    if list(got.columns) != list(want.columns) or got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: columns or rows differ")
    for n, c in want.columns.items():
        mine = got.columns[n]
        same = (len(mine.planes) == len(c.planes) and mine.offset == c.offset
                and tuple(mine.shifts) == tuple(c.shifts) and mine.is_dict == c.is_dict
                and all(b == rb and torch.equal(w, rw)
                        for (w, b), (rw, rb) in zip(mine.planes, c.planes)))
        if c.is_dict:
            same = same and [str(x) for x in mine.dictionary_host] == [str(x) for x in c.dictionary_host]
        if not same:
            raise AssertionError(f"{what}: column {n} planes differ")


def phase_dataset(cols, tmpdir, device):
    """The dataset path at SF10: lineitem sorted by l_shipdate (one host
    argsort, a table clustered by ship date) written by ``write_dataset``
    in parts of DATASET_PART_ROWS rows with the JAX benchmark's options;
    ``scan_dataset`` of the glob cold and warm, pruned by Q6's range (files
    kept by their footers, pages kept), through a manifest, Q6 and Q1
    through ``Query(glob)``, ``iter_dataset_chunks``, ``load_resident`` of
    the glob (planes == ``make_resident`` of the sorted numpy columns) with
    the resident Q6 and Q1, ``compact_dataset`` of the first 8 parts into
    2, and a warm scan inside ``device_trace`` for the device's idle share;
    every answer against numpy.  Returns the parts' paths, whose K3 groups
    the kernel line times, the resident table, whose planes it times K1
    over, and the sorted columns, which the multidevice phase checks its
    dataset scan against."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import Query, col, load_resident, make_resident
    from strawboat_tpu_torch.exec import dataset as ds
    from strawboat_tpu_torch.exec.scan import _open, page_keep_mask

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # days fit 16 bits, where numpy's stable sort is a radix sort
    order = np.argsort(cols["l_shipdate"].astype(np.uint16), kind="stable")
    data = {k: cols[k][order] for k in tpch.LINEITEM_COLUMNS}
    del order
    facts = {"sort_s": time.perf_counter() - t0}
    opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                        max_page_size=PAGE_ROWS, sample_seed=3, zone_maps=True)
    ddir = os.path.join(tmpdir, "dataset")
    with forcing({}):
        t0 = time.perf_counter()
        paths = ds.write_dataset(ddir, data, DATASET_PART_ROWS, options=opts)
    facts["write"] = {"seconds": time.perf_counter() - t0, "parts": len(paths),
                      "bytes": sum(os.path.getsize(p) for p in paths),
                      "pages_per_part": len(_open(paths[0])[1][0].pages)}
    glob = os.path.join(ddir, "part-*.str")

    runs = []
    for i in range(2):  # cold, then warm
        before = obs.counter("k3.launches")
        t0 = time.perf_counter()
        table = ds.scan_dataset(glob, device)
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0,
                     "k3_launches": obs.counter("k3.launches") - before})
        if i == 0:
            _check_columns("dataset scan", table, data)
        del table
    if min(r["k3_launches"] for r in runs) <= 0:
        raise AssertionError(f"the dataset scans did not launch K3: {runs}")
    facts["scan"] = {"runs": runs, "warm_s": runs[1]["seconds"], "equal_to_numpy": True}

    want_q6 = tpch.q6_numpy_reference(data)
    q6_cols = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
    preds = tpch.q6_pruning_predicates()
    kept = [p for p in paths if ds.file_may_match(p, preds)]
    pages = 0
    for p in kept:
        keep = page_keep_mask(p, _open(p)[1], preds)
        pages += len(_open(p)[1][0].pages) if keep is None else int(keep.sum())
    t0 = time.perf_counter()
    pruned = ds.scan_dataset(glob, device, columns=q6_cols, predicates=preds)
    got = int(tpch.q6(pruned))
    seconds = time.perf_counter() - t0
    _check_equal("Q6 over the pruned dataset scan", got, want_q6)
    if not len(kept) < len(paths):
        raise AssertionError(f"Q6's range kept every file: {len(kept)} of {len(paths)}")
    facts["q6_pruned"] = {"files_kept": len(kept), "files": len(paths), "pages_kept": pages,
                          "rows_scanned": pruned.num_rows, "seconds": seconds,
                          "revenue": want_q6, "equal_to_numpy": True}
    del pruned

    t0 = time.perf_counter()
    manifest = ds.dataset_manifest(glob)
    manifest_s = time.perf_counter() - t0
    m_kept = [e["path"] for e in manifest["parts"] if ds._part_may_match(e, preds)]
    if m_kept != kept:
        raise AssertionError(f"the manifest kept {len(m_kept)} files, the footers {len(kept)}")
    t0 = time.perf_counter()
    pruned = ds.scan_dataset_with_manifest(manifest, device, columns=q6_cols, predicates=preds)
    _check_equal("Q6 over the manifest's scan", int(tpch.q6(pruned)), want_q6)
    facts["manifest"] = {"build_s": manifest_s, "files_kept": len(m_kept),
                         "scan_q6_s": time.perf_counter() - t0, "equal_to_numpy": True}
    del pruned

    def q6_query():
        return Query(glob, device=device).filter(
            (col("l_shipdate") >= 731) & (col("l_shipdate") < 1096) & (col("l_discount") >= 5)
            & (col("l_discount") <= 7) & (col("l_quantity") < 24)
        ).agg(revenue=("sum", col("l_extendedprice") * col("l_discount"))).run()["revenue"]

    t0 = time.perf_counter()
    _check_equal("Q6 through Query(glob)", int(q6_query()), want_q6)
    facts["q6_query"] = {"seconds": time.perf_counter() - t0, "equal_to_numpy": True}
    want_q1 = tpch.q1_numpy_reference(data)
    t0 = time.perf_counter()
    _q1_check("Q1 through Query(glob)", tpch.q1_rows(tpch.q1_query(glob, device)), want_q1)
    facts["q1_query"] = {"seconds": time.perf_counter() - t0, "groups": len(want_q1),
                         "equal_to_numpy": True}

    t0 = time.perf_counter()
    total, rows = 0, 0
    for chunk in ds.iter_dataset_chunks(glob, DATASET_CHUNK_PAGES, device,
                                        columns=["l_extendedprice"]):
        total += int(chunk["l_extendedprice"].values.sum())
        rows += chunk.num_rows
    _check_equal("l_extendedprice summed over the dataset's chunks", (total, rows),
                 (int(data["l_extendedprice"].sum()), len(data["l_extendedprice"])))
    facts["chunks"] = {"chunk_pages": DATASET_CHUNK_PAGES, "seconds": time.perf_counter() - t0,
                       "equal_to_numpy": True}

    t0 = time.perf_counter()
    rt = load_resident(glob, device, columns=tpch.Q1_Q6_COLUMNS)
    torch.cuda.synchronize()
    facts["load_resident"] = {"seconds": time.perf_counter() - t0, "plane_bytes": _plane_bytes(rt)}
    _same_planes("load_resident(glob) against make_resident of the sorted columns", rt,
                 make_resident({k: data[k] for k in tpch.Q1_Q6_COLUMNS}, device))
    _check_equal("resident Q6 over the dataset", int(tpch.q6(rt)), want_q6)
    _q1_check("resident Q1 over the dataset", tpch.q1_rows(tpch.q1(rt)), want_q1)
    facts["load_resident"].update(planes_equal=True, q6_equal_to_numpy=True,
                                  q1_equal_to_numpy=True)
    torch.cuda.empty_cache()

    n8 = 8 * DATASET_PART_ROWS
    t0 = time.perf_counter()
    compacted = ds.compact_dataset(paths[:8], os.path.join(tmpdir, "compacted"), n8 // 2, device,
                                   options=opts)
    facts["compact"] = {"seconds": time.perf_counter() - t0, "parts": len(compacted)}
    head = {k: v[:n8] for k, v in data.items()}
    table = ds.scan_dataset(compacted, device)
    if len(compacted) != 2 or table.num_rows != n8:
        raise AssertionError(f"compaction gave {len(compacted)} parts of {table.num_rows} rows")
    _check_columns("compacted dataset", table, head)
    _check_equal("Q6 over the compacted parts", int(tpch.q6(table)), tpch.q6_numpy_reference(head))
    facts["compact"].update(rows=table.num_rows, equal_to_numpy=True)
    del table, head

    tr, _, first = traced(os.path.join(tmpdir, "trace"), device, "traced dataset scan",
                          lambda: ds.scan_dataset(glob, device).num_rows)
    facts["traced_scan"] = {"window_s": tr.window_s, "device_busy_s": tr.busy_s,
                            "idle_share": tr.idle_share, "longest_idle_gap_s": tr.longest_gap_s,
                            "trace_bytes": os.path.getsize(tr.path), "first_try_short": first}
    os.remove(tr.path)
    emit("dataset", rows=len(data["l_shipdate"]), part_rows=DATASET_PART_ROWS, page_rows=PAGE_ROWS,
         order="l_shipdate", options="LZ4, ratio 1.0, sample_seed 3, zone maps", **facts,
         max_memory_allocated=torch.cuda.max_memory_allocated(), nvidia_smi=nvidia_smi())
    return paths, rt, data


def _exchanges(records) -> dict:
    """Recorded collectives summed by kind: calls, bytes read and written
    by their device copies, bytes crossed to other processes
    (process-group calls), CUDA-event ms and the copies' bound (read +
    write bytes at HBM_BYTES_PER_S; None for a process-group call)."""
    from strawboat_tpu_torch.parallel.collectives import exchange_summary

    out = {}
    for r in exchange_summary(records):
        e = out.setdefault(r["op"], {"calls": 0, "read_bytes": 0, "write_bytes": 0,
                                     "crossed_bytes": 0, "ms": 0.0})
        for k in ("read_bytes", "write_bytes", "crossed_bytes", "ms"):
            e[k] += r[k]
        e["calls"] += 1
    for e in out.values():
        copied = e["read_bytes"] + e["write_bytes"]
        e["bound_ms"] = bound_ms(copied) if copied else None
    return out


def _shard_rows(valid) -> list:
    return [int(v.sum()) for v in valid.shards]


def _group_check(what: str, res, keys: np.ndarray, sums: dict) -> int:
    """A distributed aggregate's valid slots against numpy bincounts
    (``sums``: result name → per-key numpy totals)."""
    from strawboat_tpu_torch.parallel import concat_shards

    ok = _host(concat_shards(res["valid"]))
    got_keys = _host(concat_shards(res["keys"]))[ok]
    want_keys = np.flatnonzero(np.bincount(keys))
    _check_equal(f"{what}: keys", sorted(got_keys.tolist()), want_keys.tolist())
    for name, want in sums.items():
        got = _host(concat_shards(res[name]))[ok]
        if not np.array_equal(got, want[got_keys]):
            raise AssertionError(f"{what}: {name} differs from numpy")
    return len(got_keys)


def _suppkey_sums(cols) -> dict:
    """numpy's totals by l_suppkey of the aggregate below."""
    sk = cols["l_suppkey"]
    return {"qty": np.bincount(sk, weights=cols["l_quantity"]).astype(np.int64),
            "price": np.bincount(sk, weights=cols["l_extendedprice"]).astype(np.int64),
            "n": np.bincount(sk)}


def _suppkey_aggregate(par, mesh, dt):
    """``distributed_aggregate`` of a scan of the lineitem file by
    l_suppkey (10 000 groups at SF10: the capacity grows from 4096)."""
    return par.distributed_aggregate(
        mesh, "shards", dt["l_suppkey"].values,
        {"qty": ("sum", dt["l_quantity"].values), "price": ("sum", dt["l_extendedprice"].values),
         "n": ("count", dt["l_quantity"].values)}, mask=dt["__valid__"].values, num_groups=4096)


def phase_multidevice(rt, cols, paths, o_path, dataset_paths, data, tmpdir, device):
    """The multi-device layer on a mesh of MULTI_SHARDS shards on the one
    card, over what the earlier phases built: the SF10 resident table
    sharded (Q6 and the grouped sums by l_returnflag against the
    single-device table), ``distributed_scan`` of the ``dict`` integer
    file (each shard's columns against numpy over its page range),
    ``distributed_aggregate`` of it by l_suppkey (from 4096 groups, grown),
    ``distributed_join`` of lineitem with the orders file (revenue over
    o_orderdate < 1995-03-15), ``distributed_scan_dataset`` of the
    dataset's parts, ``shuffle_by_key`` of its l_returnflag codes (a hot
    key) with and without salt, ``streamed_dataset_aggregate`` pruned by
    Q6's range, and ``dryrun_multidevice``; every answer against numpy or
    the single-device path.  The exchanges' bytes, CUDA-event times and
    bound, and one aggregate's device idle share, are printed.  Returns
    the sharded table, whose planes the kernel line times K1 over, and the
    phase's answers, which the multiprocess phase's worlds must give
    (``dict_scan`` and ``dataset_scan`` stay on the card for it)."""
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import dataset as ds
    from strawboat_tpu_torch.exec.scan import _open, page_keep_mask
    from strawboat_tpu_torch.parallel import ShardedTensor, concat_shards, dist_scan
    from strawboat_tpu_torch.parallel.collectives import record_exchanges
    from strawboat_tpu_torch.parallel.dryrun import dryrun_multidevice

    torch.cuda.reset_peak_memory_stats()
    mesh = par.make_mesh(MULTI_SHARDS, device)
    facts = {"shards": MULTI_SHARDS, "devices": sorted({str(d) for d in mesh.devices.flat})}

    # the resident table sharded by tile blocks, K1 on each shard's planes
    t0 = time.perf_counter()
    srt = par.shard_resident(rt, mesh, "shards")
    torch.cuda.synchronize()
    q6 = Q6_FILTER_SUM
    n_flags = len(rt["l_returnflag"].dictionary_host)
    group = ("l_returnflag", ["l_quantity", "l_extendedprice"], n_flags)
    got = int(par.sharded_filter_sum(srt, *q6))
    _check_equal("sharded Q6 against filter_sum", got, int(rt.filter_sum(*q6)))
    _check_equal("sharded Q6", got, tpch.q6_numpy_reference(cols))
    sums, cnt = par.sharded_group_sum(srt, *group)
    want_sums, want_cnt = rt.group_sum(*group)
    if not (all(torch.equal(a, b) for a, b in zip(sums, want_sums)) and torch.equal(cnt, want_cnt)):
        raise AssertionError("sharded group_sum differs from group_sum")
    answers = {"q6": got, "group": ([s.cpu().numpy() for s in sums], cnt.cpu().numpy())}
    with record_exchanges() as recs:
        before = k1_counts()
        par.sharded_filter_sum(srt, *q6)
        q6_k1 = k1_counts(before)
        par.sharded_group_sum(srt, *group)
    if q6_k1[0] != 1:
        raise AssertionError(f"sharded Q6 launched K1 {q6_k1[0]} times, not once")
    traces = {}  # where a warm Q6's time goes: the device's busy share
    for name, run in (("sharded", lambda: par.sharded_filter_sum(srt, *q6).item()),
                      ("single_device", lambda: rt.filter_sum(*q6).item())):
        run()
        tr, _, first = traced(os.path.join(tmpdir, "traces"), device, f"traced {name} Q6", run)
        traces[name] = {"window_ms": tr.window_s * 1e3, "busy_ms": tr.busy_s * 1e3,
                        "idle_share": tr.idle_share, "kernel_ms": kernel_ms(tr.path),
                        "first_try_short": first}
    facts["resident"] = {
        "shard_s": time.perf_counter() - t0, "rows_per_shard": srt.rows_per_shard,
        "q6_k1_launches": q6_k1[0], "q6_k1_planes": q6_k1[1], "q6_traced": traces,
        "q6_ms": wall_ms(lambda: par.sharded_filter_sum(srt, *q6).item()),
        "q6_single_device_ms": wall_ms(lambda: rt.filter_sum(*q6).item()),
        "group_sum_ms": wall_ms(lambda: par.sharded_group_sum(srt, *group)[1].cpu()),
        "group_sum_single_device_ms": wall_ms(lambda: rt.group_sum(*group)[1].cpu()),
        "psum": _exchanges(recs), "equal_to_single_device": True}
    answers["q6_ms"] = facts["resident"]["q6_ms"]

    # the dict file's pages over the shards, each shard's rows against numpy
    t0 = time.perf_counter()
    dt = par.distributed_scan(paths["dict"], mesh)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    n = len(cols["l_orderkey"])
    ranges = dist_scan.shard_page_ranges(-(-n // PAGE_ROWS), MULTI_SHARDS)
    for si, r in enumerate(ranges):
        lo, hi = r.start * PAGE_ROWS, min(r.stop * PAGE_ROWS, n)
        valid = _host(dt["__valid__"].values.shards[si])
        if not (valid[: hi - lo].all() and not valid[hi - lo:].any()):
            raise AssertionError(f"distributed scan: shard {si}'s __valid__")
        for k in tpch.INT_COLUMNS:
            if not np.array_equal(_host(dt[k].values.shards[si][: hi - lo]), cols[k][lo:hi]):
                raise AssertionError(f"distributed scan: shard {si}'s {k}")
    facts["scan"] = {"seconds": scan_s, "rows_per_shard": _shard_rows(dt["__valid__"].values),
                     "padded_rows": dt.num_rows, "equal_to_numpy": True}

    # grouped by l_suppkey (10 000 groups): the capacity grows from 4096
    valid = dt["__valid__"].values

    def aggregate():
        return _suppkey_aggregate(par, mesh, dt)

    t0 = time.perf_counter()
    res = aggregate()
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    groups = _group_check("distributed aggregate by l_suppkey", res, cols["l_suppkey"],
                          _suppkey_sums(cols))
    answers["aggregate"] = {k: [t.cpu().numpy() for t in v.shards] for k, v in res.items()}
    answers["aggregate_seconds"] = agg_s
    with record_exchanges() as recs:
        aggregate()
    tr, _, first = traced(os.path.join(tmpdir, "multidevice_trace"), device, "traced aggregate",
                          aggregate)
    os.remove(tr.path)
    facts["aggregate"] = {"seconds": agg_s, "groups": groups,
                          "slots_per_shard": len(res["keys"].shards[0]),
                          "warm_ms": wall_ms(lambda: aggregate()["n"].shards[0].cpu(), reps=3),
                          "exchange": _exchanges(recs), "idle_share": tr.idle_share,
                          "device_busy_s": tr.busy_s, "window_s": tr.window_s,
                          "trace_first_try_short": first,
                          "equal_to_numpy": True}
    del res

    # lineitem ⋈ orders on the order key, revenue over o_orderdate < 1995-03-15
    orders = tpch.generate_orders(SF10_ROWS / tpch.ROWS_PER_SF, seed=1)
    t0 = time.perf_counter()
    ot = par.distributed_scan(o_path, mesh, columns=["o_orderkey", "o_orderdate"])

    def join():
        return par.distributed_join(mesh, "shards", dt["l_orderkey"].values,
                                    (dt["l_extendedprice"].values,), ot["o_orderkey"].values,
                                    (ot["o_orderdate"].values,), probe_valid=valid,
                                    build_valid=ot["__valid__"].values)

    _k, (price,), (odate,), jvalid = join()
    revenue = sum(int(torch.where(v & (d < Q3_DATE), p, 0).sum())
                  for p, d, v in zip(price.shards, odate.shards, jvalid.shards))
    matched = sum(int(v.sum()) for v in jvalid.shards)
    join_s = time.perf_counter() - t0
    lk = cols["l_orderkey"]
    hit = lk < len(orders["o_orderkey"])
    late = orders["o_orderdate"][lk[hit]] < Q3_DATE
    _check_equal("distributed join: matched rows", matched, int(hit.sum()))
    _check_equal("distributed join: revenue", revenue,
                 int(cols["l_extendedprice"][hit][late].sum()))
    del _k, price, odate, jvalid
    answers["join"] = {"matched": matched, "revenue": revenue, "seconds": join_s}
    with record_exchanges() as recs:
        out = join()
    del out
    facts["join"] = {"seconds": join_s, "probe_rows": n, "build_rows": len(orders["o_orderkey"]),
                     "build_rows_per_shard": _shard_rows(ot["__valid__"].values),
                     "matched": matched, "revenue": revenue,
                     "exchange": _exchanges(recs), "equal_to_numpy": True}
    answers["dict_scan"] = dt
    del ot, valid
    torch.cuda.empty_cache()

    # the dataset's 60 parts over the shards, one global dictionary a string
    t0 = time.perf_counter()
    dd = par.distributed_scan_dataset(dataset_paths, mesh)
    torch.cuda.synchronize()
    dscan_s = time.perf_counter() - t0
    units, opened, _schema = dist_scan._dataset_units(dataset_paths, MULTI_SHARDS)
    part = {p: i * DATASET_PART_ROWS for i, p in enumerate(dataset_paths)}
    for si, ids in enumerate(dist_scan._assign_units(units, opened, MULTI_SHARDS)):
        idx = np.concatenate([np.arange(part[p] + r.start * PAGE_ROWS,
                                        part[p] + min(r.stop * PAGE_ROWS, DATASET_PART_ROWS))
                              for p, r in (units[i] for i in ids)])
        if not _host(dd["__valid__"].values.shards[si])[: len(idx)].all():
            raise AssertionError(f"dataset scan: shard {si}'s __valid__")
        for k in tpch.LINEITEM_COLUMNS:
            got = _host(dd[k].values.shards[si][: len(idx)])
            if dd[k].dictionary is not None:
                got = np.array([v.decode() for v in dd[k].dictionary])[got]
            if not np.array_equal(got, data[k][idx]):
                raise AssertionError(f"dataset scan: shard {si}'s {k}")
    facts["dataset_scan"] = {"seconds": dscan_s, "parts": len(dataset_paths), "units": len(units),
                             "rows_per_shard": _shard_rows(dd["__valid__"].values),
                             "dictionary_sizes": {k: len(dd[k].dictionary) for k in dd.columns
                                                  if dd[k].dictionary is not None},
                             "equal_to_numpy": True}

    # a hot key: l_returnflag's codes (half the rows are 'N'), with and without salt
    key = dd["l_returnflag"].values
    m = len(key.shards[0])
    row_id = ShardedTensor(torch.arange(si * m, (si + 1) * m, device=d)
                           for si, d in enumerate(mesh.axis_devices("shards")))
    facts["shuffle"] = {}
    flat_key = concat_shards(key)
    for salt in (0, 4):
        t0 = time.perf_counter()
        k2, (r2,), v2 = par.shuffle_by_key(mesh, "shards", key, (row_id,), capacity=1 << 20,
                                           salt=salt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ok = concat_shards(v2)
        got_rows = concat_shards(r2)[ok]
        if not (torch.equal(torch.sort(got_rows).values, torch.arange(len(key), device=device))
                and torch.equal(concat_shards(k2)[ok], flat_key[got_rows])):
            raise AssertionError(f"shuffle (salt {salt}) lost or changed rows")
        facts["shuffle"][f"salt_{salt}"] = {"seconds": seconds, "rows_per_shard": _shard_rows(v2),
                                            "capacity": len(v2.shards[0]) // MULTI_SHARDS}
        del k2, r2, v2, ok, got_rows
    answers["dataset_scan"] = dd
    del key, row_id, flat_key
    torch.cuda.empty_cache()

    # streamed by l_suppkey, parts and pages pruned by Q6's range
    preds = tpch.q6_pruning_predicates()
    t0 = time.perf_counter()
    res = par.streamed_dataset_aggregate(
        mesh, "shards", dataset_paths, key="l_suppkey",
        aggs={"price": ("sum", "l_extendedprice"), "n": ("count", "l_extendedprice")},
        chunk_pages=DATASET_CHUNK_PAGES, num_groups=16384, predicates=preds)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    kept = []
    for p in dataset_paths:
        if ds.file_may_match(p, preds):
            keep = page_keep_mask(p, _open(p)[1], preds)
            rows = np.arange(DATASET_PART_ROWS) if keep is None else _pages_rows(
                keep, DATASET_PART_ROWS)
            kept.append(part[p] + rows)
    kept = np.concatenate(kept)
    sk = data["l_suppkey"][kept]
    groups = _group_check("streamed dataset aggregate", res, sk, {
        "price": np.bincount(sk, weights=data["l_extendedprice"][kept]).astype(np.int64),
        "n": np.bincount(sk)})
    facts["streamed"] = {"seconds": stream_s, "rows": len(kept), "groups": groups,
                         "equal_to_numpy": True}
    del res

    t0 = time.perf_counter()
    dry = dryrun_multidevice(MULTI_SHARDS, device)
    facts["dryrun"] = {"seconds": time.perf_counter() - t0, **dry}
    emit("multidevice", **facts, max_memory_allocated=torch.cuda.max_memory_allocated(),
         nvidia_smi=nvidia_smi(),
         exchange_note="all_to_all and psum are copies within one card (every shard on "
                       "cuda:0); the bound is their read + write bytes at 3.35 TB/s")
    return srt, answers


def _nccl_events(path: str) -> dict:
    """Events of a ``device_trace`` whose names hold "nccl", counted by
    category and name: the process group's host ranges (``cpu_op``) and
    any NCCL kernel the card ran."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("ph") == "X" and "nccl" in e.get("name", "").lower():
            key = f"{e.get('cat')}: {e['name'][:80]}"
            out[key] = out.get(key, 0) + 1
    return out


def _same_shards(what: str, got, want, first: int = 0) -> None:
    """``got``'s shards equal ``want``'s (a list of every shard of the
    mesh) from global shard ``first`` on, on the card."""
    for s, t in enumerate(got.shards):
        if not torch.equal(t, want[first + s]):
            raise AssertionError(f"{what}: shard {first + s} differs")


def _scan_shards(table) -> dict:
    """A distributed scan's columns as ``{name: (value shards, validity
    shards or None, dictionary or None)}``."""
    return {k: (list(c.values.shards), None if c.validity is None else list(c.validity.shards),
                None if c.dictionary is None else [bytes(v) for v in c.dictionary])
            for k, c in table.columns.items()}


def _same_scan(what: str, table, want: dict, first: int = 0) -> None:
    """A distributed scan's local shards against ``_scan_shards`` of the
    single-process one: values, validity and dictionaries."""
    if set(table.columns) != set(want):
        raise AssertionError(f"{what}: columns {sorted(table.columns)}")
    for k, c in table.columns.items():
        vals, valid, dictionary = want[k]
        _same_shards(f"{what}: {k}", c.values, vals, first)
        if (c.validity is None) != (valid is None):
            raise AssertionError(f"{what}: {k}'s validity")
        if valid is not None:
            _same_shards(f"{what}: {k}'s validity", c.validity, valid, first)
        if (None if c.dictionary is None else [bytes(v) for v in c.dictionary]) != dictionary:
            raise AssertionError(f"{what}: {k}'s dictionary")


def _same_aggregate(what: str, res, want: dict, sums: dict, first: int = 0) -> int:
    """A distributed aggregate's local shards against the single-process
    one's (``want``: name → every shard as numpy), and its valid slots
    against numpy (``sums``: name → per-key totals); → the groups held."""
    groups = 0
    for s in range(len(res["keys"].shards)):
        for k, v in res.items():
            if not np.array_equal(v.shards[s].cpu().numpy(), want[k][first + s]):
                raise AssertionError(f"{what}: shard {first + s}'s {k}")
        ok = res["valid"].shards[s].cpu().numpy()
        keys = res["keys"].shards[s].cpu().numpy()[ok]
        for name, total in sums.items():
            if not np.array_equal(res[name].shards[s].cpu().numpy()[ok], total[keys]):
                raise AssertionError(f"{what}: shard {first + s}'s {name} against numpy")
        groups += len(keys)
    return groups


def _same_group(what: str, got, want) -> None:
    """Grouped sums and counts against the single-process mesh's (numpy)."""
    (sums, cnt), (want_sums, want_cnt) = got, want
    if not (all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(sums, want_sums))
            and np.array_equal(cnt.cpu().numpy(), want_cnt)):
        raise AssertionError(f"{what}: grouped sums differ from the single-process mesh's")


def _timed(fn, device):
    """``fn()`` and its seconds, the device's work inside."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# the resident columns the multiprocess ranks load: Q6's and the group key
RANK_COLUMNS = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice", "l_returnflag")
WORLD_TIMEOUT_S = 120  # one collective's limit inside the multiprocess phase's worlds
WORLD_LIMIT_S = 300  # the two-rank world's, spawn to exit


def multiprocess_rank(rank: int, spec: dict) -> None:
    """One rank of the multiprocess phase's gloo world on the one card:
    its share of the SF10 resident table loaded from the lineitem_full file
    (sharded Q6, one K1 launch, and the grouped sums), of the ``dict``
    file's ``distributed_scan`` and of the dataset's
    ``distributed_scan_dataset`` (each local shard equal to the
    multidevice phase's same shard, handed over on the card), and of the
    ``distributed_aggregate`` by l_suppkey (each local shard equal to the
    multidevice phase's, its slots to numpy's sums); its facts go to
    ``rank<r>.json`` in ``spec["out"]``."""
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.exec import load_resident
    from strawboat_tpu_torch.parallel.collectives import record_exchanges

    device = torch.device(spec["device"])
    started = time.perf_counter()
    par.distributed_init(spec["store"], 2, rank, device, backend="gloo",
                         timeout=WORLD_TIMEOUT_S)
    mesh = par.make_mesh(MULTI_SHARDS, device)
    first = mesh.first_shard
    facts = {"rank": rank, "first_shard": first, "shards": len(mesh.axis_devices("shards"))}
    rt, facts["load_s"] = _timed(lambda: load_resident(spec["full_path"], device,
                                                       columns=list(RANK_COLUMNS)), device)
    k3_load = obs.counter("k3.launches")
    srt = par.shard_resident(rt, mesh, "shards")
    del rt
    before = k1_counts()
    q6 = int(par.sharded_filter_sum(srt, *Q6_FILTER_SUM))
    facts["q6_k1"] = k1_counts(before)
    if facts["q6_k1"][0] != 1:
        raise AssertionError(f"rank {rank}: sharded Q6 launched K1 {facts['q6_k1'][0]} times")
    if q6 != spec["q6"]:
        raise AssertionError(f"rank {rank}: sharded Q6 {q6} != the single-process {spec['q6']}")
    _check_equal(f"rank {rank}: sharded Q6", q6, spec["q6_numpy"])
    _same_group(f"rank {rank}", par.sharded_group_sum(
        srt, "l_returnflag", ["l_quantity", "l_extendedprice"],
        len(srt["l_returnflag"].dictionary_host)), spec["group"])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    times = []
    for _ in range(REPS + 1):
        t0 = time.perf_counter()
        par.sharded_filter_sum(srt, *Q6_FILTER_SUM).item()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    facts["q6_ms"] = statistics.median(times[1:])
    del srt

    k3 = obs.counter("k3.launches")
    dt, facts["scan_s"] = _timed(lambda: par.distributed_scan(spec["dict_path"], mesh), device)
    facts["scan_k3"] = obs.counter("k3.launches") - k3
    _same_scan(f"rank {rank}: distributed scan", dt, spec["dict_scan"], first)
    res, facts["aggregate_s"] = _timed(lambda: _suppkey_aggregate(par, mesh, dt), device)
    facts["aggregate_groups"] = _same_aggregate(f"rank {rank}: distributed aggregate", res,
                                                spec["aggregate"], spec["aggregate_sums"], first)
    facts["aggregate_slots_per_shard"] = len(res["keys"].shards[0])
    with record_exchanges() as recs:
        _suppkey_aggregate(par, mesh, dt)
        sync()
    facts["aggregate_exchange"] = _exchanges(recs)
    del dt, res

    k3 = obs.counter("k3.launches")
    dd, facts["dataset_scan_s"] = _timed(
        lambda: par.distributed_scan_dataset(spec["dataset_paths"], mesh), device)
    facts["dataset_scan_k3"] = obs.counter("k3.launches") - k3
    _same_scan(f"rank {rank}: distributed dataset scan", dd, spec["dataset_scan"], first)
    facts["rows_per_shard"] = [int(v.sum()) for v in dd["__valid__"].values.shards]
    del dd
    facts["k1_launches"] = obs.counter("k1.launches")
    facts["k3_launches"] = obs.counter("k3.launches")
    facts["k3_load_launches"] = k3_load
    torch.distributed.destroy_process_group()
    facts["seconds"] = time.perf_counter() - started
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)


def phase_multiprocess(rt, cols, paths, o_path, full_path, dataset_paths, answers, tmpdir,
                       device) -> dict:
    """The mesh across processes, over what the earlier phases built, at the
    multidevice phase's width (MULTI_SHARDS shards over SF10):

    (a) a world of one process under NCCL (gloo on the CPU) on ``device``:
    the sharded resident Q6 and grouped sums, ``distributed_scan`` of the
    ``dict`` file, ``distributed_aggregate`` by l_suppkey (from 4096
    groups, grown) and ``distributed_join`` with the orders file, each
    equal to the multidevice phase's answer, with the process group's
    events in a traced Q6; the group is destroyed afterwards;

    (b) a world of two processes on the one card under gloo (NCCL refuses
    two ranks on one card), two shards each, spawned here
    (:func:`multiprocess_rank`): each rank's shards equal the same shards
    of the multidevice phase's results, which this process hands over
    (the scans' shards on the card).  A rank that fails, or a world that
    outlives WORLD_LIMIT_S, fails the phase.

    → the launches of K1 and K3 on the path (this process's and the
    ranks')."""
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.parallel.collectives import record_exchanges

    started = time.perf_counter()
    smi = nvidia_smi() if device.type == "cuda" else None
    facts = {"shards": MULTI_SHARDS}
    suppkey_sums = _suppkey_sums(cols)

    # (a) a world of one process
    launches = (obs.counter("k1.launches"), obs.counter("k3.launches"))
    par.distributed_init(f"file://{os.path.join(tmpdir, 'world_of_one')}", 1, 0, device,
                         timeout=WORLD_TIMEOUT_S)
    try:
        one = {"backend": torch.distributed.get_backend()}
        mesh = par.make_mesh(MULTI_SHARDS, device)
        srt = par.shard_resident(rt, mesh, "shards")
        before = k1_counts()
        q6 = int(par.sharded_filter_sum(srt, *Q6_FILTER_SUM))
        one["q6_k1"] = k1_counts(before)
        if (q6, one["q6_k1"][0]) != (answers["q6"], 1):
            raise AssertionError(f"world of one: sharded Q6 {q6} in {one['q6_k1'][0]} K1 "
                                 f"launches, not the single-process {answers['q6']} in one")
        _same_group("world of one", par.sharded_group_sum(
            srt, "l_returnflag", ["l_quantity", "l_extendedprice"],
            len(rt["l_returnflag"].dictionary_host)), answers["group"])
        one["q6_ms"] = wall_ms(lambda: par.sharded_filter_sum(srt, *Q6_FILTER_SUM).item())
        with record_exchanges() as recs:
            par.sharded_filter_sum(srt, *Q6_FILTER_SUM).item()
        one["q6_exchange"] = _exchanges(recs)
        tr, _, first = traced(os.path.join(tmpdir, "traces"), device, "traced world-of-one Q6",
                              lambda: par.sharded_filter_sum(srt, *Q6_FILTER_SUM).item())
        one["q6_traced"] = {"nccl_events": _nccl_events(tr.path), "busy_ms": tr.busy_s * 1e3,
                            "window_ms": tr.window_s * 1e3, "first_try_short": first}
        os.remove(tr.path)
        del srt
        dt, one["scan_s"] = _timed(lambda: par.distributed_scan(paths["dict"], mesh), device)
        _same_scan("world of one: distributed scan", dt, _scan_shards(answers["dict_scan"]))
        res, one["aggregate_s"] = _timed(lambda: _suppkey_aggregate(par, mesh, dt), device)
        one["aggregate_groups"] = _same_aggregate("world of one: distributed aggregate", res,
                                                  answers["aggregate"], suppkey_sums)
        with record_exchanges() as recs:
            _suppkey_aggregate(par, mesh, dt)
        one["aggregate_exchange"] = _exchanges(recs)
        del res
        ot = par.distributed_scan(o_path, mesh, columns=["o_orderkey", "o_orderdate"])

        def join():
            return par.distributed_join(
                mesh, "shards", dt["l_orderkey"].values, (dt["l_extendedprice"].values,),
                ot["o_orderkey"].values, (ot["o_orderdate"].values,),
                probe_valid=dt["__valid__"].values, build_valid=ot["__valid__"].values)

        (_k, (price,), (odate,), jvalid), one["join_s"] = _timed(join, device)
        matched = sum(int(v.sum()) for v in jvalid.shards)
        revenue = sum(int(torch.where(v & (d < Q3_DATE), p, 0).sum())
                      for p, d, v in zip(price.shards, odate.shards, jvalid.shards))
        if (matched, revenue) != (answers["join"]["matched"], answers["join"]["revenue"]):
            raise AssertionError(f"world of one: join matched {matched} rows, revenue {revenue}, "
                                 f"not the single-process mesh's {answers['join']}")
        del _k, price, odate, jvalid
        with record_exchanges() as recs:
            out = join()
        del out
        one["join_exchange"] = _exchanges(recs)
        del dt, ot
    finally:
        torch.distributed.destroy_process_group()
    one["launches"] = {"K1": obs.counter("k1.launches") - launches[0],
                       "K3": obs.counter("k3.launches") - launches[1]}
    facts["world_of_one"] = one
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (b) two processes on the one card
    out = os.path.join(tmpdir, "ranks")
    os.makedirs(out, exist_ok=True)
    spec = {"device": str(device), "store": f"file://{os.path.join(tmpdir, 'world_of_two')}",
            "out": out, "full_path": full_path, "dict_path": paths["dict"],
            "dataset_paths": list(dataset_paths), "q6": answers["q6"],
            "q6_numpy": tpch.q6_numpy_reference(cols), "group": answers["group"],
            "aggregate": answers["aggregate"], "aggregate_sums": suppkey_sums,
            "dict_scan": _scan_shards(answers["dict_scan"]),
            "dataset_scan": _scan_shards(answers["dataset_scan"])}
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(multiprocess_rank, args=(spec,), nprocs=2,
                                                join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > WORLD_LIMIT_S:
                raise AssertionError(f"the two-rank world outlived {WORLD_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    del spec  # the scans' shards the ranks mapped, released
    if device.type == "cuda":
        torch.cuda.ipc_collect()
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    facts["world_of_two"] = {"backend": "gloo", "seconds": time.perf_counter() - t0,
                             "ranks": ranks, "q6_ms_single_process": answers["q6_ms"],
                             "aggregate_s_single_process": answers["aggregate_seconds"]}
    launches = {"K1": one["launches"]["K1"] + sum(r["k1_launches"] for r in ranks),
                "K3": one["launches"]["K3"] + sum(r["k3_launches"] for r in ranks)}
    emit("multiprocess", **facts, launches=launches, phase_s=time.perf_counter() - started,
         nvidia_smi=smi,
         exchange_note="crossed_bytes: what a rank sent the others (all_to_all_single) or "
                       "reduced with them (all_reduce), 0 in the world of one; under gloo "
                       "they pass through host memory on one card, so neither world's ms "
                       "is a scale-out number")
    return launches


def _fixed_columns(rng, n: int) -> dict:
    """The fixed-size binaries of the port_close phase as the integers of
    their widths: a one-letter flag, a two-letter country code of 200, an
    IPv4 address in 10.0.0.0/8 and a 64-bit hash."""
    letters = np.frombuffer(b"ANR", np.int8)
    countries = rng.integers(65, 91, (200, 2), dtype=np.uint8).view("<i2").reshape(-1)
    return {"flag": rng.choice(letters, n), "country": rng.choice(countries, n),
            "ipv4": (rng.integers(0, 1 << 24, n, dtype=np.int64) + (10 << 24)).astype("<i4"),
            "hash64": rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)}


def _fixed_arrow_ints(arr, w: int) -> np.ndarray:
    """A ``fixed_size_binary[w]`` arrow array's values as ints of width w."""
    if hasattr(arr, "combine_chunks"):
        arr = arr.combine_chunks()
    raw = np.frombuffer(arr.buffers()[1], np.uint8)[arr.offset * w : (arr.offset + len(arr)) * w]
    return raw.view(f"<i{w}")


def run_config_scripts(env_base) -> dict:
    """The scripts of BASELINE configs 4 and 5 on the card, together, each
    in its own process; each must exit 0 with its checks passed (a last
    line of JSON with ``"ok": true``) → {script: its wall seconds and
    summary}."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for script, args, env in CONFIG_SCRIPTS:
        out = tempfile.TemporaryFile(mode="w+")
        err = tempfile.TemporaryFile(mode="w+")
        cmd = [sys.executable, os.path.join(root, script), "--device", "cuda", *args]
        procs.append((script, subprocess.Popen(cmd, cwd=root, env={**env_base, **env}, stdout=out,
                                               stderr=err), out, err, time.perf_counter()))
    ended = {}
    while len(ended) < len(procs):
        time.sleep(0.05)
        for script, proc, _out, _err, t0 in procs:
            if script in ended:
                continue
            if proc.poll() is None and time.perf_counter() - t0 > SCRIPT_LIMIT_S:
                proc.kill()
                proc.wait()
            if proc.poll() is not None:
                ended[script] = time.perf_counter() - t0
    done, failed = {}, []
    for script, proc, out, err, _t0 in procs:
        out.seek(0)
        err.seek(0)
        lines = out.read().strip().splitlines()
        try:
            summary = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            summary = None
        if proc.returncode != 0 or not summary or summary.get("ok") is not True:
            failed.append(f"{script}: exit {proc.returncode}; {err.read()[-2000:]}")
        done[script] = {"seconds": ended[script], "summary": summary}
    if failed:
        raise AssertionError("config scripts failed: " + " | ".join(failed))
    return done


def phase_port_close(full_path, cols, tmpdir, device) -> dict:
    """The port's last slice on the card.  Fixed-size binaries:
    ``FIXED_ROWS`` rows of ``flag`` [1], ``country`` [2], ``ipv4`` [4] and
    ``hash64`` [8] written under the ``dict`` flags with zone maps (and a
    file of ``FIXED_LIST_ROWS`` rows of a list<fixed_size_binary[2]>
    column), and again under the ``bitpack`` flags; ``scan_file`` of
    both on the card (each column the generated integers, its width's
    dtype; K3 decodes flag's DICT index pages and, under ``bitpack``,
    every page of ipv4, once a group its plan holds), a
    ``Query`` filter on ipv4's range against numpy, ``read_table`` equal to
    the generated table, ``load_resident`` refused as in the reference.
    ``q1_dense`` over a scan of the lineitem_full file equal to ``q1`` and
    to numpy, each warm (median of 5).  Then the scripts of configs 4 and
    5 as subprocesses on the card (``run_config_scripts``).  Returns the
    three files' paths (the kernel line times K3 over them) and the facts."""
    import pyarrow as pa

    from strawboat_tpu_torch import api, columns as cm
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.errors import NotYetImplementedError
    from strawboat_tpu_torch.exec import Query, col, load_resident, scan_file
    from strawboat_tpu_torch.exec.scan import k3_launch_groups
    from strawboat_tpu_torch.schema import Field, list_of
    from strawboat_tpu_torch.write import write_file

    widths = {"flag": 1, "country": 2, "ipv4": 4, "hash64": 8}
    rng = np.random.default_rng(SEED)
    fixed = _fixed_columns(rng, FIXED_ROWS)
    path = os.path.join(tmpdir, "fixed.str")
    schema = [Field(k, f"fixed_size_binary[{w}]") for k, w in widths.items()]
    opts = WriteOptions(max_page_size=PAGE_ROWS, zone_maps=True)
    with forcing(FILES["dict"]):
        t0 = time.perf_counter()
        write_file(path, fixed, schema=schema, options=opts)
        write_s = time.perf_counter() - t0
        lens = rng.integers(0, 4, FIXED_LIST_ROWS)
        offsets = np.zeros(FIXED_LIST_ROWS + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        leaf = rng.choice(fixed["country"][:200_000], int(offsets[-1]))
        list_path = os.path.join(tmpdir, "fixed_list.str")
        write_file(list_path, {"codes": cm.ListColumn("list", None, offsets, cm.PrimitiveColumn(
            "fixed_size_binary[2]", None, leaf))},
            schema=[list_of("codes", Field("item", "fixed_size_binary[2]"))], options=opts)
    facts = {"rows": FIXED_ROWS, "reduced": f"{FIXED_ROWS} of SF10's {SF10_ROWS} rows",
             "decoded_bytes": FIXED_ROWS * sum(widths.values()),
             "write": {"seconds": write_s, "bytes": os.path.getsize(path)}}

    # the same columns under the bitpack flags: ipv4's 4-byte pages are
    # bit-packed, so K3 decodes them on the card at the phase's rows
    bitpack_path = os.path.join(tmpdir, "fixed_bitpack.str")
    with forcing(FILES["bitpack"]):
        t0 = time.perf_counter()
        write_file(bitpack_path, fixed, schema=schema, options=opts)
        facts["write"]["bitpack_seconds"] = time.perf_counter() - t0
        facts["write"]["bitpack_bytes"] = os.path.getsize(bitpack_path)

    def scan_checked(p):
        """(seconds, K3 launches, K3 groups by column) of a cold scan of
        ``p``, each column held against the generated integers; K3 must
        launch once a group ``k3_launch_groups`` plans, and at least once."""
        groups = {}
        for name, key, pages, _words in k3_launch_groups(p):
            groups.setdefault(name, []).append([int(key[1]), len(pages)])
        before = obs.counter("k3.launches")
        t0 = time.perf_counter()
        table = scan_file(p, device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = obs.counter("k3.launches") - before
        for k, w in widths.items():
            c = table[k]
            if c.values.device.type != device.type or c.values.element_size() != w \
                    or c.dtype != f"fixed_size_binary[{w}]":
                raise AssertionError(f"fixed-binary scan of {p}: {k} is {c.dtype} "
                                     f"{c.values.dtype} on {c.values.device}")
            if not np.array_equal(_host(c.values), fixed[k]):
                raise AssertionError(f"fixed-binary scan of {p}: {k} != the generated integers")
        del table
        planned = sum(len(g) for g in groups.values())
        if launches <= 0 or launches != planned:
            raise AssertionError(f"the fixed-binary scan of {p} launched K3 {launches} times, "
                                 f"its plan {planned}")
        return seconds, launches, groups

    scan_s, launches, groups = scan_checked(path)
    facts["scan"] = {"seconds": scan_s, "k3_launches": launches, "k3_groups": groups,
                     "equal_to_generated": True,
                     "warm_ms": wall_ms(lambda: scan_file(path, device), reps=1)}
    scan_s, launches, groups = scan_checked(bitpack_path)
    ipv4_pages = sum(n for _b, n in groups.get("ipv4", ()))
    if ipv4_pages < FIXED_ROWS // PAGE_ROWS:  # every whole page is bit-packed
        raise AssertionError(f"K3 decoded {ipv4_pages} of ipv4's pages under the bitpack flags")
    facts["scan_bitpack"] = {"seconds": scan_s, "k3_launches": launches, "k3_groups": groups,
                             "equal_to_generated": True}
    lt = scan_file(list_path, device)
    if not (np.array_equal(_host(lt["codes"].values), leaf)
            and np.array_equal(_host(lt["codes"].offsets), offsets)):
        raise AssertionError("the list<fixed_size_binary[2]> scan != the generated column")
    del lt

    lo, hi = (10 << 24) + (1 << 20), (10 << 24) + (3 << 20)
    want = {"c": int(((fixed["ipv4"] >= lo) & (fixed["ipv4"] < hi)).sum())}
    m = (fixed["ipv4"] >= lo) & (fixed["ipv4"] < hi)
    want["s"] = int(fixed["country"][m].astype(np.int64).sum())
    q = Query(path, device=device).filter((col("ipv4") >= lo) & (col("ipv4") < hi)).agg(
        c=("count", "hash64"), s=("sum", "country"))
    got = q.run()
    _check_equal("Query over ipv4's range", {"c": int(got["c"]), "s": int(got["s"])}, want)
    facts["query"] = {**want, "equal_to_numpy": True, "warm_ms": wall_ms(
        lambda: int(q.run()["c"]), reps=1)}

    t0 = time.perf_counter()
    back = api.read_table(path)
    read_s = time.perf_counter() - t0
    for k, w in widths.items():
        if back.schema.field(k).type != pa.binary(w) or back[k].null_count \
                or not np.array_equal(_fixed_arrow_ints(back[k], w), fixed[k]):
            raise AssertionError(f"read_table of the fixed-binary file: {k}")
    del back
    lb = api.read_table(list_path)["codes"].combine_chunks()
    if lb.type != pa.list_(pa.binary(2)) or not np.array_equal(
            _fixed_arrow_ints(lb.values, 2), leaf):
        raise AssertionError("read_table of the list<fixed_size_binary[2]> file")
    facts["read_table"] = {"seconds": read_s, "equal_to_generated": True}
    try:
        load_resident(path, device, columns=["flag"])
    except NotYetImplementedError as e:
        if "resident load of column 'flag' type fixed_size_binary[1]" not in str(e):
            raise
        facts["load_resident"] = {"raises": str(e)}
    else:
        raise AssertionError("load_resident of a fixed-size binary did not raise")
    del fixed, leaf

    dt = scan_file(full_path, device, columns=list(tpch.Q1_Q6_COLUMNS))
    want_q1 = tpch.q1_numpy_reference(cols)
    dense = tpch.q1_table_rows(tpch.q1_dense(dt))
    _q1_check("q1_dense over the lineitem_full scan", dense, want_q1)
    _q1_check("q1 over the lineitem_full scan", tpch.q1_rows(tpch.q1(dt)), dense)
    facts["q1_dense"] = {
        "groups": len(dense), "equal_to_q1_and_numpy": True,
        "warm_median_ms": wall_ms(lambda: tpch.q1_dense(dt), reps=5),
        "q1_warm_median_ms": wall_ms(lambda: tpch.q1_rows(tpch.q1(dt)), reps=5)}
    del dt
    torch.cuda.empty_cache()

    env = {k: v for k, v in os.environ.items() if not k.startswith("STRAWBOAT_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    facts["scripts"] = run_config_scripts(env)
    facts["scripts_seconds"] = time.perf_counter() - t0
    # the scripts' own processes count their kernels' launches
    facts["script_launches"] = {k: sum(d["summary"].get(f"{k.lower()}_launches", 0)
                                       for d in facts["scripts"].values()) for k in ("K1", "K3")}
    emit("port_close", **facts, nvidia_smi=nvidia_smi())
    return {"fixed": path, "fixed_bitpack": bitpack_path, "fixed_list": list_path}, facts


def k3_summary(paths, device) -> dict:
    """K3 held exactly against its plain version, then K3 and plain times
    and the bound, over every launch one scan of each file in ``paths``
    makes (a name maps to a path, or to a dataset's list of parts); the
    ``k3_groups`` line has them per file and per launch (column, width,
    blocks), a dataset's as totals and its count of launches.  ``ms`` is
    the CUDA event window around each launch, ``device_ms`` the kernel's
    own duration (one profiler trace over every file's launches)."""
    from strawboat_tpu_torch.exec.scan import k3_launch_groups
    from strawboat_tpu_torch.kernels import bitunpack as bu

    files = {}
    launches = {}  # name → [(words on the card, b)]
    for name, path in paths.items():
        groups = []
        launches[name] = []
        # a dataset's hundreds of small groups: fewer repetitions each
        reps, warmup = (REPS, 3) if isinstance(path, str) else (DATASET_K3_REPS, 1)
        for part in [path] if isinstance(path, str) else path:
            for col, (_codec, b), _pages, words in k3_launch_groups(part):
                w = torch.from_numpy(words.view(np.int32)).to(device)
                if not torch.equal(bu.bitunpack_natural(w, 0, b), bu.bitunpack_natural_plain(w, 0, b)):
                    raise AssertionError(f"K3 disagrees with plain over {part}/{col}: b={b}")
                launches[name].append((w, b))
                groups.append({"column": col, "b": b, "n_blocks": words.shape[0],
                               "ms": event_ms(lambda: bu.bitunpack_natural(w, 0, b), reps, warmup),
                               "plain_ms": event_ms(lambda: bu.bitunpack_natural_plain(w, 0, b),
                                                    reps, warmup),
                               "bound_ms": bound_ms(k3_bytes(b, words.shape[0]))})
        files[name] = {k: sum(g[k] for g in groups) for k in ("ms", "plain_ms", "bound_ms")}
        if isinstance(path, str):
            files[name]["groups"] = groups
        else:
            files[name].update(parts=len(path), launch_groups=len(groups))
    first_try_short = {}
    for single in (True, False):  # the files' launches, then the datasets'
        names = [n for n, p in paths.items() if isinstance(p, str) == single]
        calls = [(lambda w=w, b=b: bu.bitunpack_natural(w, 0, b), None, "bitunpack")
                 for n in names for w, b in launches[n]]
        dev, first = device_ms(calls, reps=REPS if single else DATASET_K3_REPS)
        if first:
            first_try_short["files" if single else "datasets"] = first
        dev = iter(dev)
        for n in names:
            per = [next(dev) for _ in launches[n]]
            files[n]["device_ms"] = sum(per)
            if single:
                for g, d in zip(files[n]["groups"], per):
                    g["device_ms"] = d
            else:
                files[n]["device_ms_per_launch"] = [min(per), statistics.median(per), max(per)]
    del launches
    first_try_short = first_try_short or None
    emit("k3_groups", files=files, device_ms_first_try_short=first_try_short)
    return {**{k: sum(f[k] for f in files.values()) for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "device_ms_first_try_short": first_try_short}


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
    # the K2 / K0 path: its own launches
    base = {k: obs.counter(k) for k in ("k2.launches", "k0.launches")}
    for b, want, w3, wt in inputs:
        n = len(want)
        k2 = bu.bitunpack_tiled_to_flat(bu.bitunpack_tiled_unseeded(w3, b))[:n]
        k0 = bu.bitunpack_tmajor_natural(wt, b)[:n]
        for name, got in (("K2", k2), ("K0", k0)):
            if not np.array_equal(got.cpu().numpy(), want):
                raise AssertionError(f"{name} path over l_shipdate b={b} != the generated column")
    launches = {"K2": obs.counter("k2.launches") - base["k2.launches"],
                "K0": obs.counter("k0.launches") - base["k0.launches"]}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the K2/K0 path did not launch both kernels: {launches}")
    times = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
             for k in ("K2", "K0")}
    dev, first = device_ms([call for b, _want, w3, wt in inputs for call in (
        (lambda w3=w3, b=b: bu.bitunpack_tiled_unseeded(w3, b), None, "bitunpack"),
        (lambda wt=wt, b=b: bu.bitunpack_tmajor(wt, b), None, "bitunpack"))])
    dev = iter(dev)
    per_launch = []
    for b, _want, w3, wt in inputs:
        one = {
            "K2": {"n_lanes": w3.shape[0] * w3.shape[2],
                   "ms": event_ms(lambda: bu.bitunpack_tiled_unseeded(w3, b)),
                   "device_ms": next(dev),
                   "plain_ms": event_ms(lambda: bu.bitunpack_tiled_unseeded_plain(w3, b)),
                   # b words in, 32 values out per lane column
                   "bound_ms": bound_ms(w3.numel() * 4 * (b + 32) // b)},
            "K0": {"n_lanes": wt.shape[1],
                   "ms": event_ms(lambda: bu.bitunpack_tmajor(wt, b)),
                   "device_ms": next(dev),
                   "plain_ms": event_ms(lambda: bu.bitunpack_tmajor_plain(wt, b)),
                   "bound_ms": bound_ms(wt.numel() * 4 * (b + 32) // b)},
        }
        for k in ("K2", "K0"):
            for f in ("ms", "device_ms", "plain_ms", "bound_ms"):
                times[k][f] += one[k][f]
        per_launch.append({"b": b, **one})
    emit("k2_k0", widths_checked=32, max_abs_err=0, path_widths=[g[0] for g in groups],
         launches=launches, times=times, per_launch=per_launch, equal_to_numpy=True,
         device_ms_first_try_short=first)
    return {k: {"launches": launches[k], "max_abs_err": 0, **times[k],
                "device_ms_first_try_short": first} for k in launches}


def k1_summary(tables, nested_rt, srt) -> dict:
    """K1 over every plane shape the paths decode, once each: the
    host-encoded planes of the resident table (Q1, Q6 and the general
    queries over it; Q6 over load_resident decodes planes equal to these
    word for word), the device-direct planes of make_resident(scan), those
    of the float64 money scan and of the dataset's resident table
    (``tables``), the nested table's lengths, leaf and validity planes, and
    the sharded table's.  A table's planes go in one call as its queries
    make it (``ms``, ``device_ms``; held equal to the plain version plane
    by plane first), and a launch a plane as the parent
    made them (``per_plane_ms``, ``per_plane_device_ms``); the
    ``k1_groups`` line has the totals."""
    from strawboat_tpu_torch.kernels import bitunpack as bu

    groups = [[(w, b) for c in t.columns.values() for w, b in c.planes] for t in tables]
    groups.append([p for c in nested_rt.columns.values() for p in _all_planes(c)])
    groups.append([p for c in srt.columns.values() for local in c.local for p in local.planes])
    planes = [p for g in groups for p in g]
    launches = [_k1_many_equal(f"K1 table {i}'s planes", g) for i, g in enumerate(groups)]
    k1 = {"ms": sum(event_ms(lambda g=g: bu.bitunpack_tiled_many(g)) for g in groups),
          "per_plane_ms": sum(event_ms(lambda w=w, b=b: bu.bitunpack_tiled(w, 0, b))
                              for w, b in planes)}
    dev, k1["device_ms_first_try_short"] = device_ms(
        [(lambda g=g: bu.bitunpack_tiled_many(g), None, "bitunpack") for g in groups]
        + [(lambda w=w, b=b: bu.bitunpack_tiled(w, 0, b), None, "bitunpack") for w, b in planes])
    k1["device_ms"] = sum(dev[: len(groups)])
    k1["per_plane_device_ms"] = sum(dev[len(groups):])
    # the plain version repeats the kernel's arithmetic in torch ops: a few
    # reps tell its time
    k1["plain_ms"] = sum(event_ms(lambda w=w, b=b: bu.bitunpack_tiled_plain(w, 0, b), 5, 1)
                         for w, b in planes)
    k1["bound_ms"] = sum(bound_ms(k1_bytes([p])) for p in planes)
    emit("k1_groups", planes=[len(g) for g in groups], launches=launches, **k1)
    return k1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.kernels import _build, bitunpack as bu

    started = time.perf_counter()
    phase_s = {}  # seconds from the start to the end of each path
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    with obs.recording() as built:
        _build.load_all(["bitunpack", "bitunpack_natural", "group_agg", "filter_sum"])
    emit("build", kernels=["bitunpack", "bitunpack_natural", "group_agg", "filter_sum"],
         seconds=time.perf_counter() - t0,
         compile_seconds={s.attrs["kernel"]: s.seconds
                          for s in built.spans("strawboat.kernel.build")},
         nvcc=_build.nvcc_path())

    k1 = phase_kernel(device, SEED, bu.TILE3D)
    k3 = phase_kernel_natural(device, SEED)

    t0 = time.perf_counter()
    cols = tpch.generate_lineitem(1.0, seed=SEED, rows=SF10_ROWS)
    emit("generate", rows=SF10_ROWS, seed=SEED, seconds=time.perf_counter() - t0)
    phase_s["generate"] = time.perf_counter() - started

    # the planes K1 decodes on every path, by tile count, from here to the
    # multi-device path's end
    tiles = contextlib.ExitStack()
    k1_tiles = tiles.enter_context(k1_plane_tiles())

    # the resident path: count only its launches
    base = kernel_counts()
    rt = phase_load(cols, device)
    phase_q6(rt, cols)
    phase_q1(rt, cols)
    k1_launches = kernel_counts(base)["K1"]
    k6_timed = obs.counter("k6.launches")
    k6 = phase_k6(rt)
    k6_timed = obs.counter("k6.launches") - k6_timed  # the k6 phase's own calls
    k7_timed = obs.counter("k7.launches")
    k7 = phase_k7(rt)
    k7_timed = obs.counter("k7.launches") - k7_timed  # the k7 phase's own calls
    if k1_launches <= 0:
        raise AssertionError("the resident path never launched K1")
    phase_s["resident"] = time.perf_counter() - started

    with tempfile.TemporaryDirectory() as tmpdir:
        # the scan path: count only its launches
        base = kernel_counts()
        paths = phase_write(cols, tmpdir)
        tables = phase_scan(paths, cols, device)
        phase_q6_scan(tables, cols)
        k3_launches = kernel_counts(base)["K3"]
        if k3_launches <= 0:
            raise AssertionError("the scan path never launched K3")
        del tables
        torch.cuda.empty_cache()
        phase_s["scan"] = time.perf_counter() - started
        # the general path: count only its launches
        base = kernel_counts()
        o_path, scan_rt = phase_general(paths, cols, rt, tmpdir, device)
        general = kernel_counts(base)
        if min(general.values()) <= 0:
            raise AssertionError(f"the general path did not launch K1 and K3: {general}")
        k1_launches += general["K1"]
        k3_launches += general["K3"]
        torch.cuda.empty_cache()
        phase_s["general"] = time.perf_counter() - started
        # the whole lineitem file: count only its launches
        base = kernel_counts()
        full_path = phase_lineitem_full(cols, tmpdir, device)
        full = kernel_counts(base)
        if min(full.values()) <= 0:
            raise AssertionError(f"the lineitem_full path did not launch K1 and K3: {full}")
        k1_launches += full["K1"]
        k3_launches += full["K3"]
        torch.cuda.empty_cache()
        phase_s["lineitem_full"] = time.perf_counter() - started
        # the file-format API over the same file: count only its launches
        base = kernel_counts()
        phase_file_api(full_path, cols, tmpdir, device)
        file_api = {"K3": kernel_counts(base)["K3"]}
        if file_api["K3"] <= 0:
            raise AssertionError("the file_api path never launched K3")
        k3_launches += file_api["K3"]
        torch.cuda.empty_cache()
        phase_s["file_api"] = time.perf_counter() - started
        # the typed lineitem files: count only their launches
        base = kernel_counts()
        typed_paths, float_rt = phase_lineitem_typed(
            {k: np.ascontiguousarray(v[::TYPED_STRIDE]) for k, v in cols.items()}, tmpdir, device)
        typed = kernel_counts(base)
        if min(typed.values()) <= 0:
            raise AssertionError(f"the lineitem_typed path did not launch K1 and K3: {typed}")
        k1_launches += typed["K1"]
        k3_launches += typed["K3"]
        torch.cuda.empty_cache()
        phase_s["lineitem_typed"] = time.perf_counter() - started
        # the nested orders file: count only its launches
        base = kernel_counts()
        nested_path, nested_rt = phase_nested(tmpdir, device)
        nested = kernel_counts(base)
        if min(nested.values()) <= 0:
            raise AssertionError(f"the nested path did not launch K1 and K3: {nested}")
        k1_launches += nested["K1"]
        k3_launches += nested["K3"]
        torch.cuda.empty_cache()
        phase_s["nested"] = time.perf_counter() - started
        # the adaptive write path: count only its launches
        base = kernel_counts()
        adaptive_paths = phase_adaptive({k: v[:ADAPTIVE_ROWS] for k, v in cols.items()}, tmpdir,
                                        device)
        adaptive = {"K3": kernel_counts(base)["K3"]}
        if adaptive["K3"] <= 0:
            raise AssertionError("the adaptive path never launched K3")
        k3_launches += adaptive["K3"]
        torch.cuda.empty_cache()
        phase_s["adaptive"] = time.perf_counter() - started
        # the dataset path: count only its launches
        base = kernel_counts()
        dataset_paths, dataset_rt, sorted_cols = phase_dataset(cols, tmpdir, device)
        dataset = kernel_counts(base)
        if min(dataset.values()) <= 0:
            raise AssertionError(f"the dataset path did not launch K1 and K3: {dataset}")
        k1_launches += dataset["K1"]
        k3_launches += dataset["K3"]
        torch.cuda.empty_cache()
        phase_s["dataset"] = time.perf_counter() - started
        # the multi-device path: count only its launches
        base = kernel_counts()
        srt, answers = phase_multidevice(rt, cols, paths, o_path, dataset_paths, sorted_cols,
                                         tmpdir, device)
        multi = kernel_counts(base)
        if min(multi.values()) <= 0:
            raise AssertionError(f"the multidevice path did not launch K1 and K3: {multi}")
        k1_launches += multi["K1"]
        k3_launches += multi["K3"]
        del sorted_cols
        torch.cuda.empty_cache()
        phase_s["multidevice"] = time.perf_counter() - started
        # the mesh across processes: this process's launches and its ranks'
        base = kernel_counts()
        multiprocess = phase_multiprocess(rt, cols, paths, o_path, full_path, dataset_paths,
                                          answers, tmpdir, device)
        if min(multiprocess.values()) <= 0:
            raise AssertionError(f"the multiprocess path did not launch K1 and K3: {multiprocess}")
        k1_launches += multiprocess["K1"]
        k3_launches += multiprocess["K3"]
        del answers
        torch.cuda.empty_cache()
        phase_s["multiprocess"] = time.perf_counter() - started
        # the port's last slice (fixed-size binaries, q1_dense, the config
        # 4 and 5 scripts): this process's launches and its scripts'
        base = kernel_counts()
        fixed_paths, closing = phase_port_close(full_path, cols, tmpdir, device)
        port_close = {k: n + closing["script_launches"][k] for k, n in kernel_counts(base).items()}
        if min(port_close.values()) <= 0:
            raise AssertionError(f"the port_close path did not launch K1 and K3: {port_close}")
        k1_launches += port_close["K1"]
        k3_launches += port_close["K3"]
        torch.cuda.empty_cache()
        phase_s["port_close"] = time.perf_counter() - started
        tiles.close()
        # a lone 1-tile plane's device time (the kernel phase's (1, b)
        # shapes) times the path's calls of such planes alone
        one_tile_ms = statistics.mean(k1["times"][f"1x{b}"]["device_ms"] for b in PATH_WIDTHS)
        k1_tiles["one_tile_device_ms"] = one_tile_ms
        k1_tiles["lone_one_tile_device_ms"] = one_tile_ms * k1_tiles["lone_one_tile_calls"]
        # K3 over one scan of each file the paths scan: the two integer
        # lineitem files, the orders file, the whole lineitem file, the
        # typed ones, the nested orders file, the two adaptive files, the
        # dataset and the fixed-size binary files
        k3.update(k3_summary({**paths, "orders": o_path, "lineitem_full": full_path,
                              **typed_paths, "orders_nested": nested_path, **adaptive_paths,
                              "dataset": dataset_paths, **fixed_paths}, device))
        phase_s["k3_summary"] = time.perf_counter() - started
        k2_k0 = phase_k2_k0(paths["bitpack"], cols["l_shipdate"], device, SEED)
    phase_k1_batching(rt, srt)
    k1.update(k1_summary([rt, scan_rt, float_rt, dataset_rt], nested_rt, srt))
    del rt, scan_rt, float_rt, nested_rt, dataset_rt, srt

    def line(name, src, replaces, launches, facts):
        return {"name": name, "route": "cuda", "source": CSRC + src, "replaces": PALLAS + replaces,
                "launches": launches, "max_abs_err": facts["max_abs_err"], "ms": facts["ms"],
                "device_ms": facts["device_ms"], "plain_ms": facts["plain_ms"],
                "bound_ms": facts["bound_ms"], "bound_by": "bytes",
                # no single torch call unpacks BitPacker4x
                "library_ms": None,
                # what a trace behind device_ms lacked before it was retaken
                "device_ms_first_try_short": facts["device_ms_first_try_short"]}

    emit("launches", general_path=general, lineitem_full_path=full, file_api_path=file_api,
         lineitem_typed_path=typed,
         nested_path=nested, adaptive_path=adaptive, dataset_path=dataset, multidevice_path=multi,
         multiprocess_path=multiprocess, port_close_path=port_close,
         k1_plane_tiles=k1_tiles, script_s=time.perf_counter() - started, phase_end_s=phase_s)
    print(json.dumps({"kernels": [
        line("bitunpack_tiled", "bitunpack.cu", "222", k1_launches, k1),
        line("bitunpack_tiled_unseeded", "bitunpack.cu", "174", k2_k0["K2"]["launches"], k2_k0["K2"]),
        line("bitunpack_tmajor", "bitunpack.cu", "41", k2_k0["K0"]["launches"], k2_k0["K0"]),
        line("bitunpack_natural", "bitunpack_natural.cu", "298", k3_launches, k3),
        # every launch but the k6 phase's own calls
        dict(line("group_agg", "group_agg.cu", "", obs.counter("k6.launches") - k6_timed, k6),
             replaces="strawboat_tpu/exec/aggregate.py:233 dense_group_sum (a one-hot matmul "
                      "XLA fuses, no Pallas kernel)"),
        # every launch but the k7 phase's own calls
        dict(line("filter_sum", "filter_sum.cu", "", obs.counter("k7.launches") - k7_timed, k7),
             replaces="strawboat_tpu/exec/resident.py:547 filter_sum (the compares, product "
                      "and sum XLA fuses in one jit, no Pallas kernel)"),
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

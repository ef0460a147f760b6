"""Codec-choice logging and device tracing.

Counterpart of ``log_codec_choice`` / ``log_compress_ratio`` in
``strawboat_tpu/util/obs.py`` (the reference's ``log`` statements at its
codec-choice and ratio points, integer/mod.rs:44-47, 65-68, 288-293), on
the ``"strawboat_tpu_torch"`` logger: a handler at INFO sees one record per
page, ``"choose <family> compression : <codec>"`` with the family and the
codec's name as its arguments.  :func:`device_trace` profiles a region
through ``torch.profiler`` and reads the device's idle share from the
trace (the reference's ``device_trace``, ``util/obs.py:28``);
:func:`trace_device_ranges` reads the device's own durations from it,
by the host range that launched them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("strawboat_tpu_torch")


def log_codec_choice(family: str, codec) -> None:
    if log.isEnabledFor(logging.INFO):
        log.info("choose %s compression : %s", family, getattr(codec, "name", codec))


def log_compress_ratio(family: str, total_bytes: int, compressed: int) -> None:
    if log.isEnabledFor(logging.DEBUG) and compressed:
        log.debug("%s compress ratio %s", family, total_bytes / compressed)


# ---------------------------------------------------------------------------
# device tracing (counterpart of the reference's ``device_trace``, over
# ``torch.profiler`` instead of ``jax.profiler``)

_TRACE_SPAN = "strawboat_device_trace"
# chrome-trace categories of work on the card (kernels, copies, memsets)
_CUDA_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# seconds of idle launches between a CUDA profiler session's start and its
# span: late in a long process a session records kernels only some ms after
# it starts (on an H100, 5.6 ms and the first 45 launches in one trace; a
# traced sharded Q6 lost its first kernels without the lead-in)
_LEAD_IN_S = 0.05


@dataclass
class DeviceTrace:
    """What :func:`device_trace` measured over its window: the Chrome
    trace's path, the window (seconds), the device's busy time (the union
    of its intervals, seconds), ``idle_share = 1 - busy / window``, the
    longest stretch the device sat idle (seconds), and the kernel launches
    in the window whose kernel the trace lacks (not 0: the other numbers
    miss that work)."""

    path: Optional[str] = None
    window_s: float = 0.0
    busy_s: float = 0.0
    idle_share: float = 1.0
    longest_gap_s: float = 0.0
    lost_kernels: int = 0
    # seconds from the window's start to the first and the last lost launch
    lost_span_s: Tuple[float, float] = (0.0, 0.0)


def trace_busy(path: str, device_type: str) -> DeviceTrace:
    """Busy time and idle share of the device over the traced window, from
    a Chrome trace written by :func:`device_trace`: on a CUDA device its
    kernels, copies and memsets; on the CPU its top-level operators."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == _TRACE_SPAN and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"{path}: no {_TRACE_SPAN!r} span")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    cats = _CUDA_CATS if device_type == "cuda" else ("cpu_op",)
    iv = sorted((max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0)), hi))
                for e in events if e.get("cat") in cats)
    busy, gap, end = 0.0, 0.0, lo
    for a, b in iv:
        if b <= a:
            continue
        if a > end:
            gap = max(gap, a - end)
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    gap = max(gap, hi - end)
    window = hi - lo
    idle = 1.0 - busy / window if window > 0 else 0.0
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "") and lo <= float(e["ts"]) <= hi
                and "correlation" in e.get("args", {})}
    recorded = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    lost = sorted(ts for c, ts in launched.items() if c not in recorded)
    span = ((lost[0] - lo) * 1e-6, (lost[-1] - lo) * 1e-6) if lost else (0.0, 0.0)
    return DeviceTrace(path, window * 1e-6, busy * 1e-6, idle, gap * 1e-6, len(lost), span)


def trace_device_ranges(path: str, prefix: str) -> Dict[str, List[Tuple[str, float]]]:
    """The device's kernels, copies and memsets in a Chrome trace written
    by :func:`device_trace`, grouped by the ``record_function`` range
    (a name starting with ``prefix``) in which the host launched them:
    ``{range name: [(name, duration in seconds)]}`` in start order, each
    record matched to its launch through the runtime call's correlation
    id, so a record lost from the trace cannot shift the others."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(prefix))
    starts = [r[0] for r in ranges]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out: Dict[str, List[Tuple[str, float]]] = {name: [] for _lo, _hi, name in ranges}
    device = sorted((e for e in events if e.get("cat") in _CUDA_CATS), key=lambda e: float(e["ts"]))
    for e in device:
        ts = launched.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            out[ranges[i][2]].append((e.get("name", ""), float(e.get("dur", 0)) * 1e-6))
    return out


@contextlib.contextmanager
def device_trace(logdir: str, device):
    """Profile a region on ``device``: ``with device_trace(logdir, "cuda")
    as tr: run()``, then ``tr.idle_share``.  CUDA activity is traced on a
    CUDA device (CPU activity too, for the window), CPU activity on the
    CPU; on a CUDA device ``_LEAD_IN_S`` of idle launches precede the
    span; the device is synchronized at both ends, the Chrome trace is
    written under ``logdir`` (open it in Perfetto or chrome://tracing) and
    ``tr`` is filled in from it by :func:`trace_busy`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..device import as_device

    dev = as_device(device)
    cuda = dev.type == "cuda"
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = DeviceTrace()
    if cuda:
        torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        if cuda:
            lead = torch.zeros(1, device=dev)
            end = time.perf_counter() + _LEAD_IN_S
            while time.perf_counter() < end:
                lead.add_(1)
                torch.cuda.synchronize(dev)
        with record_function(_TRACE_SPAN):
            yield out
            if cuda:
                torch.cuda.synchronize(dev)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    out.__dict__.update(trace_busy(path, dev.type).__dict__)

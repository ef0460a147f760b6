"""Codec-choice logging and device tracing.

Counterpart of ``log_codec_choice`` / ``log_compress_ratio`` in
``strawboat_tpu/util/obs.py`` (the reference's ``log`` statements at its
codec-choice and ratio points, integer/mod.rs:44-47, 65-68, 288-293), on
the ``"strawboat_tpu_torch"`` logger: a handler at INFO sees one record per
page, ``"choose <family> compression : <codec>"`` with the family and the
codec's name as its arguments.  :func:`device_trace` profiles a region
through ``torch.profiler`` and reads the device's idle share from the
trace (the reference's ``device_trace``, ``util/obs.py:28``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

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


@dataclass
class DeviceTrace:
    """What :func:`device_trace` measured over its window: the Chrome
    trace's path, the window (seconds), the device's busy time (the union
    of its intervals, seconds), ``idle_share = 1 - busy / window`` and the
    longest stretch the device sat idle (seconds)."""

    path: Optional[str] = None
    window_s: float = 0.0
    busy_s: float = 0.0
    idle_share: float = 1.0
    longest_gap_s: float = 0.0


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
    return DeviceTrace(path, window * 1e-6, busy * 1e-6, idle, gap * 1e-6)


@contextlib.contextmanager
def device_trace(logdir: str, device):
    """Profile a region on ``device``: ``with device_trace(logdir, "cuda")
    as tr: run()``, then ``tr.idle_share``.  CUDA activity is traced on a
    CUDA device (CPU activity too, for the window), CPU activity on the
    CPU; the device is synchronized at both ends, the Chrome trace is
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
        with record_function(_TRACE_SPAN):
            yield out
            if cuda:
                torch.cuda.synchronize(dev)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    out.__dict__.update(trace_busy(path, dev.type).__dict__)

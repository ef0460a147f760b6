"""Spans and counters, codec-choice logging and device tracing.

The program's one recorder.  :func:`span` times a phase of the work
(``with span("strawboat.query.decode", device=dev): ...``) and
:func:`count` adds to a process-wide counter (``count("k1.launches")``).
Recording is off by default: a span then costs one check and is a shared
no-op, a counter one locked integer add.  It is on while a
``torch.profiler`` session records in the thread that opens a root span,
and inside :func:`recording` (every thread).  The decision is taken when
a root opens and its children inherit it; a child in another thread gets
its parent passed in (``span(name, parent=p)``, ``p = current()``).
While a profiler records, every span also opens a ``record_function``
range of its name, so the program's phases sit in the Chrome trace on the
profiler's clock beside the kernels.  A span opened with a CUDA
``device`` records start and end events on its current stream, read
(``Span.device_ms``) only when asked.  The last finished roots stay in
memory, bounded (:func:`last_roots`); ``recording()`` gives the roots and
the counter increments of its block.

Also: ``log_codec_choice``, the counterpart of the reference's ``log``
statement at its codec-choice point (integer/mod.rs:44-47, 65-68), on the
``"strawboat_tpu_torch"`` logger: a handler at INFO sees one record per
page, ``"choose <family> compression : <codec>"``.  :func:`device_trace`
profiles a region through ``torch.profiler`` and reads the device's idle
share from the trace (the reference's ``device_trace``,
``util/obs.py:28``); :func:`trace_device_ranges` reads the device's own
durations from it, by the host range that launched them.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled

log = logging.getLogger("strawboat_tpu_torch")


def log_codec_choice(family: str, codec) -> None:
    if log.isEnabledFor(logging.INFO):
        log.info("choose %s compression : %s", family, getattr(codec, "name", codec))


# ---------------------------------------------------------------------------
# spans and counters

# finished roots kept in memory: the last _MAX_ROOTS, fewer when they hold
# more than _MAX_SPANS spans together (a 1 M-row write holds about 1,500)
_MAX_ROOTS = 4096
_MAX_SPANS = 1 << 18

_lock = threading.Lock()  # guards _counters, _live, _recording, the ring
_tls = threading.local()  # .span: the innermost recorded span open in this thread
_counters: Dict[str, int] = {}
_live = 0  # recorded spans open in any thread
_recording = 0  # open recording() blocks
_roots: collections.deque = collections.deque()
_ring_spans = 0
_ids = itertools.count(1)
_finished = itertools.count(1)


class Span:
    """One recorded span: ``name``, ``attrs``, ``id``, ``parent`` (None at a
    root), ``root``, ``thread``, host ``start_ns`` / ``end_ns``
    (``time.perf_counter_ns``), the ``counts`` added while it was the
    innermost open span of its thread, its ``children`` in start order,
    and ``seq``, its place in the order spans finish."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "thread", "start_ns", "end_ns",
                 "counts", "children", "seq", "size", "_device", "_events", "_rf", "_prev")

    def __init__(self, name: str, parent: Optional["Span"], device, attrs: dict):
        self.name, self.attrs, self.parent = name, attrs, parent
        self.root = self if parent is None else parent.root
        self.id = next(_ids)
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0
        self.counts: Dict[str, int] = {}
        self.children: List[Span] = []
        self.seq = 0
        self.size = 1  # spans under a root, itself included (roots only)
        self._device = device if device is not None and device.type == "cuda" else None
        self._events = self._rf = self._prev = None
        if parent is not None:
            parent.children.append(self)
            self.root.size += 1

    def __enter__(self) -> "Span":
        global _live
        with _lock:
            _live += 1
        self._prev = getattr(_tls, "span", None)
        _tls.span = self
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self._device is not None:
            stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            self._events[0].record(stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _live
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _tls.span = self._prev
        self._prev = None
        self.seq = next(_finished)
        with _lock:
            _live -= 1
            if self.parent is None:
                _keep(self)
        return False

    @property
    def root_id(self) -> int:
        return self.root.id

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def self_seconds(self) -> float:
        """Its time less that of its children in its own thread."""
        inner = sum(c.end_ns - c.start_ns for c in self.children if c.thread == self.thread)
        return (self.end_ns - self.start_ns - inner) * 1e-9

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between its CUDA events (waits for the end event),
        or None for a span without them."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])

    def walk(self) -> Iterator["Span"]:
        """It and every span under it, depth first in start order."""
        yield self
        for c in list(self.children):
            yield from c.walk()


class _NoSpan:
    """What :func:`span` returns when recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _NoSpan()


def _keep(root: Span) -> None:
    """A finished root into the bounded ring (under ``_lock``)."""
    global _ring_spans
    _roots.append(root)
    _ring_spans += root.size
    while len(_roots) > 1 and (len(_roots) > _MAX_ROOTS or _ring_spans > _MAX_SPANS):
        _ring_spans -= _roots.popleft().size


def span(name: str, *, parent=None, device=None, **attrs):
    """A context manager timing ``name``: a :class:`Span` when recording is
    on (a child of ``parent``, else of this thread's innermost open span,
    else a root that decides), else the shared no-op.  ``device``: a
    CUDA ``torch.device`` adds start and end events on its current
    stream."""
    if parent is None:
        if _live:
            parent = getattr(_tls, "span", None)
        if parent is None and not (_recording or _profiler_enabled()):
            return NOOP
    elif parent is NOOP:
        return NOOP
    return Span(name, parent, device, attrs)


def current() -> Optional[Span]:
    """This thread's innermost open recorded span (None when there is
    none): the parent to hand a job that runs in another thread."""
    return getattr(_tls, "span", None) if _live else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, and to the counts of this thread's
    innermost open recorded span."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
    if _live:
        sp = getattr(_tls, "span", None)
        if sp is not None:
            sp.counts[name] = sp.counts.get(name, 0) + n


def counter(name: str) -> int:
    """Counter ``name``'s total in this process."""
    return _counters.get(name, 0)


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counters)


def last_roots(n: Optional[int] = None, name: Optional[str] = None) -> List[Span]:
    """The last ``n`` (None: all kept) finished root spans, named ``name``
    when given, oldest first."""
    with _lock:
        roots = [r for r in _roots if name is None or r.name == name]
    return roots if n is None else roots[max(len(roots) - n, 0):] if n > 0 else []


class Recording:
    """What :func:`recording` gives: the roots that finished inside its
    block (``roots``), every span of them named with ``prefix``
    (``spans(prefix)``, in the order they finished) and the counters'
    increments (``counters``)."""

    def __init__(self):
        with _lock:
            self._base = dict(_counters)
            self._lo = next(_finished)
        self._hi: Optional[int] = None
        self._end: Optional[Dict[str, int]] = None

    def _close(self) -> None:
        self._end = counters()
        self._hi = next(_finished)

    @property
    def roots(self) -> List[Span]:
        with _lock:
            return [r for r in _roots if r.seq > self._lo and (self._hi is None or r.seq < self._hi)]

    def spans(self, prefix: str = "") -> List[Span]:
        out = [s for r in self.roots for s in r.walk() if s.name.startswith(prefix)]
        return sorted(out, key=lambda s: s.seq)

    @property
    def counters(self) -> Dict[str, int]:
        now = self._end if self._end is not None else counters()
        return {k: v - self._base.get(k, 0) for k, v in now.items() if v != self._base.get(k, 0)}


@contextlib.contextmanager
def recording():
    """Record every span in every thread inside the block: ``with
    recording() as rec: run()``, then ``rec.roots``, ``rec.spans(prefix)``
    and ``rec.counters``."""
    global _recording
    rec = Recording()
    with _lock:
        _recording += 1
    try:
        yield rec
    finally:
        with _lock:
            _recording -= 1
        rec._close()


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

"""Reading a ``torch.profiler`` Chrome trace of a traced stretch.

The busy-time arithmetic is a frozen copy of the port's
``util/obs.py`` ``trace_busy``: the device's busy time is the union of its
kernels, copies and memsets inside the span, the idle share is one less
busy over the span, and a launch inside the span whose kernel the trace
lacks counts as lost.  The rest reads what the device ran by name and
what the host was doing in each idle gap.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# chrome-trace categories of work on the card (kernels, copies, memsets)
CUDA_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# categories of what the host does, for naming an idle gap
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """What one traced span held: its window and the device's busy time
    (seconds), the idle share, the longest idle gap (seconds), the
    launches whose kernel the trace lacks, and the device's records and
    the host's ranges inside the span as (start, end, name) in seconds."""

    window_s: float = 0.0
    busy_s: float = 0.0
    idle_share: float = 1.0
    longest_gap_s: float = 0.0
    lost_kernels: int = 0
    device: List[Tuple[float, float, str, str]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)
    gaps: List[Tuple[float, float]] = field(default_factory=list)

    def kernel_seconds(self, substring: str) -> float:
        """Device seconds of the kernels whose name holds ``substring``."""
        return sum(b - a for a, b, name, cat in self.device
                   if cat == "kernel" and substring in name)

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time: [[name, seconds]],
        names shortened by :func:`short_name`."""
        by: Dict[str, float] = defaultdict(float)
        for a, b, name, _cat in self.device:
            by[short_name(name)] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest idle gaps, each named by what the host was doing:
        the innermost host range that covers half the gap or more, else
        the one that overlaps it most ("idle" where none does):
        [[name, seconds]]."""
        out = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]:
            over = [(min(b, hb) - max(a, ha), hb - ha, name) for ha, hb, name in self.host]
            over = [o for o in over if o[0] > 0]
            half = [o for o in over if o[0] >= (b - a) / 2]
            if half:
                name = min(half, key=lambda o: o[1])[2]
            elif over:
                name = max(over, key=lambda o: o[0])[2]
            else:
                name = "idle"
            out.append([name, b - a])
        return out


def short_name(name: str, keep: int = 120) -> str:
    """A kernel's name without its return type, its template arguments
    and its parameter list (``void f<T>(int)`` → ``f<>``), at most
    ``keep`` characters."""
    if "<" not in name and not name.startswith("void "):
        return name[:keep]
    out, depth = [], 0
    for ch in name[5:] if name.startswith("void ") else name:
        if ch == "<":
            depth += 1
            if depth == 1:
                out.append("<>")
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0 and out:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:keep] or name[:keep]


def read(path: str, span: str, device_type: str = "cuda") -> Trace:
    """The trace of the ``record_function(span)`` range in the Chrome
    trace at ``path``; on the CPU the top-level operators stand in for the
    device's work."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == span and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"{path}: no {span!r} span")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    cats = CUDA_CATS if device_type == "cuda" else ("cpu_op",)
    recs = []
    for e in events:
        if e.get("cat") not in cats:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), hi)
        if b > a:
            recs.append((a, b, e.get("name", ""), e.get("cat")))
    recs.sort()
    busy, gap, end = 0.0, 0.0, lo
    gaps = []
    for a, b, _n, _c in recs:
        if a > end:
            gap = max(gap, a - end)
            gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if hi > end:
        gaps.append((end, hi))
    gap = max(gap, hi - end)
    window = hi - lo
    idle = 1.0 - busy / window if window > 0 else 0.0
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "") and lo <= float(e["ts"]) <= hi
                and "correlation" in e.get("args", {})}
    recorded = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    lost = len(launched - recorded)
    host = [(float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6,
             e.get("name", ""))
            for e in events if e.get("cat") in HOST_CATS and e.get("name") != span
            and float(e["ts"]) < hi and float(e["ts"]) + float(e.get("dur", 0)) > lo]
    return Trace(window * 1e-6, busy * 1e-6, idle, gap * 1e-6, lost,
                 [(a * 1e-6, b * 1e-6, n, c) for a, b, n, c in recs], host,
                 [(a * 1e-6, b * 1e-6) for a, b in gaps])

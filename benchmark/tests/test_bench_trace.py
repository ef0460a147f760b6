"""The trace arithmetic on a small Chrome trace made by hand (times in
microseconds, as torch.profiler writes them)."""

import json

import pytest

from benchmark.lib import trace

SPAN = "span"


def _trace_file(tmp_path, extra=()):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": SPAN, "ts": 1000, "dur": 1000},
        # host: a query range and a host op inside the idle gap 1600..1900
        {"ph": "X", "cat": "user_annotation", "name": "query", "ts": 1000, "dur": 990},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 1550, "dur": 400},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1010, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1020, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1030, "dur": 5,
         "args": {"correlation": 3}},
        # device: 1100..1300 and 1250..1400 overlap (busy 300), 1400..1500 a copy,
        # 1900..1950 a kernel, one starting before the span (clipped to 1000..1050)
        {"ph": "X", "cat": "kernel", "name": "bitunpack_tiled_many_kernel", "ts": 1100, "dur": 200,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "where_kernel", "ts": 1250, "dur": 150,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1400, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "bitunpack_tiled_many_kernel", "ts": 1900, "dur": 50,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "early", "ts": 900, "dur": 150,
         "args": {"correlation": 8}},
        *extra,
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_busy_idle_gaps_and_lost(tmp_path):
    t = trace.read(_trace_file(tmp_path), SPAN)
    assert t.window_s == pytest.approx(1000e-6)
    # 1000..1050, 1100..1500, 1900..1950
    assert t.busy_s == pytest.approx(500e-6)
    assert t.idle_share == pytest.approx(0.5)
    assert t.longest_gap_s == pytest.approx(400e-6)
    assert t.lost_kernels == 1  # correlation 3 has no kernel
    assert t.kernel_seconds("bitunpack_tiled_many_kernel") == pytest.approx(250e-6)


def test_device_ops_and_named_gaps(tmp_path):
    t = trace.read(_trace_file(tmp_path), SPAN)
    ops = dict(t.device_ops())
    assert ops["bitunpack_tiled_many_kernel"] == pytest.approx(250e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(100e-6)
    gaps = t.idle_gaps()
    assert gaps[0][0] == "aten::nonzero" and gaps[0][1] == pytest.approx(400e-6)
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)


def test_missing_span_raises(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError):
        trace.read(str(p), SPAN)


def test_trace_busy_matches_the_ports_arithmetic(tmp_path):
    """The frozen copy gives the port's ``trace_busy`` numbers on the same
    trace (the port's span name put in)."""
    from strawboat_tpu_torch.util import obs

    path = _trace_file(tmp_path)
    ev = json.load(open(path))
    ev["traceEvents"][0]["name"] = obs._TRACE_SPAN
    p2 = tmp_path / "t2.json"
    p2.write_text(json.dumps(ev))
    mine = trace.read(str(p2), obs._TRACE_SPAN)
    theirs = obs.trace_busy(str(p2), "cuda")
    assert (mine.busy_s, mine.idle_share, mine.longest_gap_s, mine.lost_kernels) == pytest.approx(
        (theirs.busy_s, theirs.idle_share, theirs.longest_gap_s, theirs.lost_kernels))

"""The port's recorder (``util/obs.py``): spans and counters, and the
spans the resident query, the writer, the scan, the kernel build and the
collectives open.

Off by default, a span is a shared no-op and opens no profiler range; on
inside ``recording()`` or while a ``torch.profiler`` session records.
Recording changes no answer: resident Q1 and Q6, a written file's bytes
and a scan are the same with it on and off.
"""

import concurrent.futures as cf
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.exec import make_resident, scan_file
from strawboat_tpu_torch.exec.scan import host_values
from strawboat_tpu_torch.kernels import bitunpack as bu
from strawboat_tpu_torch.util import obs

ROWS = 20_000


@pytest.fixture(scope="module")
def cols():
    return tpch.generate_lineitem(1.0, seed=3, rows=ROWS)


@pytest.fixture(scope="module")
def rt(cols):
    return make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, "cpu", tile=512)


def _trace(tmp_path, run):
    """The ``user_annotation`` ranges of a CPU profiler trace of ``run``:
    [(name, start, end, thread)]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid"))
            for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _total(span, counter):
    """``counter``'s counts in ``span`` and every span under it."""
    return sum(s.counts.get(counter, 0) for s in span.walk())


def _inside(ranges, child, parent):
    """Every ``child`` range lies inside a ``parent`` range of its thread."""
    kids = [r for r in ranges if r[0] == child]
    outer = [r for r in ranges if r[0] == parent]
    return bool(kids) and all(any(o[1] <= k[1] and k[2] <= o[2] and o[3] == k[3] for o in outer)
                              for k in kids)


# ---------------------------------------------------------------------------
# the recorder


def test_span_is_a_shared_noop_when_off():
    a, b = obs.span("strawboat.test"), obs.span("strawboat.test", device=torch.device("cpu"))
    assert a is obs.NOOP and b is obs.NOOP
    with a as sp:
        assert sp is a and obs.current() is None


def test_nothing_is_recorded_and_no_range_opened_when_off(tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    kept = len(obs.last_roots())
    with obs.span("strawboat.test.off"):
        with obs.span("strawboat.test.off.child"):
            obs.count("test.off")
    assert opened == [] and len(obs.last_roots()) == kept
    assert obs.counter("test.off") >= 1  # counters count with recording off


def test_nesting_ids_self_time_and_counts():
    with obs.recording() as rec:
        with obs.span("strawboat.test", path="a") as root:
            obs.count("test.root", 2)
            with obs.span("strawboat.test.one") as one:
                obs.count("test.one")
                with obs.span("strawboat.test.one.inner") as inner:
                    assert obs.current() is inner
                    obs.count("test.one", 3)
            with obs.span("strawboat.test.two") as two:
                pass
    assert rec.roots == [root] and root.attrs == {"path": "a"}
    assert [s.name for s in root.walk()] == [
        "strawboat.test", "strawboat.test.one", "strawboat.test.one.inner", "strawboat.test.two"]
    assert root.parent is None and root.root_id == root.id
    assert one.parent is root and inner.parent is one and inner.root_id == root.id
    assert len({root.id, one.id, inner.id, two.id}) == 4
    assert root.counts == {"test.root": 2} and one.counts == {"test.one": 1}
    assert inner.counts == {"test.one": 3} and _total(root, "test.one") == 4
    assert rec.counters["test.root"] == 2 and rec.counters["test.one"] == 4
    assert root.start_ns <= one.start_ns <= inner.start_ns <= inner.end_ns <= one.end_ns
    assert one.end_ns <= two.start_ns <= two.end_ns <= root.end_ns
    assert root.self_seconds == pytest.approx(
        root.seconds - one.seconds - two.seconds, abs=1e-9)
    assert one.self_seconds == pytest.approx(one.seconds - inner.seconds, abs=1e-9)
    assert [s.name for s in rec.spans("strawboat.test.one")] == [
        "strawboat.test.one.inner", "strawboat.test.one"]  # the order they finished
    assert obs.last_roots(1, "strawboat.test") == [root]


def test_children_in_pool_threads_inherit_their_parent():
    with obs.recording() as rec:
        with obs.span("strawboat.test.pool") as root:
            parent = obs.current()

            def job(i):
                with obs.span("strawboat.test.pool.job", parent=parent, i=i):
                    obs.count("test.jobs")
                    with obs.span("strawboat.test.pool.job.inner"):
                        pass
                return obs.current()

            with cf.ThreadPoolExecutor(3) as pool:
                after = list(pool.map(job, range(6)))
    assert after == [None] * 6 and rec.roots == [root]
    jobs = [s for s in root.children if s.name == "strawboat.test.pool.job"]
    assert sorted(s.attrs["i"] for s in jobs) == list(range(6))
    assert all(s.root is root and s.children[0].parent is s for s in jobs)
    assert _total(root, "test.jobs") == 6 and rec.counters["test.jobs"] == 6
    # self time leaves out only the children that ran in the root's thread
    inner = sum(s.end_ns - s.start_ns for s in jobs if s.thread == root.thread)
    assert root.self_seconds == pytest.approx(root.seconds - inner * 1e-9, abs=1e-9)


def test_a_job_of_an_unrecorded_parent_records_nothing():
    kept = len(obs.last_roots())
    parent = obs.current()
    assert parent is None
    with cf.ThreadPoolExecutor(2) as pool:
        assert pool.submit(obs.span, "strawboat.test.job", parent=parent).result() is obs.NOOP
    assert obs.span("strawboat.test.job", parent=obs.NOOP) is obs.NOOP
    assert len(obs.last_roots()) == kept


def test_the_profiler_turns_recording_on_and_ranges_sit_in_its_trace(tmp_path):
    def run():
        with obs.span("strawboat.test.prof"):
            with obs.span("strawboat.test.prof.child"):
                torch.ones(100).sum()

    ranges = _trace(tmp_path, run)
    assert _inside(ranges, "strawboat.test.prof.child", "strawboat.test.prof")
    root = obs.last_roots(1, "strawboat.test.prof")[0]
    assert [c.name for c in root.children] == ["strawboat.test.prof.child"]


def test_the_ring_of_roots_is_bounded(monkeypatch):
    monkeypatch.setattr(obs, "_MAX_ROOTS", 5)
    with obs.recording() as rec:
        for i in range(12):
            with obs.span("strawboat.test.ring", i=i):
                pass
    assert [r.attrs["i"] for r in obs.last_roots(name="strawboat.test.ring")][-5:] == list(
        range(7, 12))
    assert len(obs.last_roots()) <= 5 and len(rec.roots) <= 5
    assert [r.attrs["i"] for r in obs.last_roots(2, "strawboat.test.ring")] == [10, 11]
    assert obs.last_roots(0) == []


def test_launch_counts_keeps_its_keys_and_reads_the_counters():
    got = bu.launch_counts()
    assert set(got) == {"k1_launches", "k3_launches", "k6_launches"}
    assert got == {"k1_launches": obs.counter("k1.launches"),
                   "k3_launches": obs.counter("k3.launches"),
                   "k6_launches": obs.counter("k6.launches")}


def test_a_kernel_build_is_a_span_and_a_count(tmp_path, monkeypatch):
    from strawboat_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "true")
    before = obs.counter("kernel.builds")
    with obs.recording() as rec:  # as load_all builds: in a pool's threads
        with cf.ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda k: _build._compile(k, str(tmp_path / f"{k}.cu"),
                                                    str(tmp_path / f"lib{k}.so")), ["k0", "k1"]))
    spans = rec.spans("strawboat.kernel.build")
    assert sorted(sp.attrs["kernel"] for sp in spans) == ["k0", "k1"]
    assert all(sp.parent is None and sp.seconds > 0 for sp in spans)
    assert obs.counter("kernel.builds") == before + 2 and rec.counters["kernel.builds"] == 2


def test_exchanges_are_spans_with_their_bytes():
    from strawboat_tpu_torch.parallel import all_to_all, make_mesh, psum
    from strawboat_tpu_torch.parallel.collectives import exchange_summary, record_exchanges

    rng = np.random.default_rng(6)
    bins = [torch.from_numpy(rng.integers(-(2**62), 2**62, (4, 100))) for _ in range(4)]
    devs = make_mesh(4, "cpu").axis_devices("shards")
    with record_exchanges() as recs:
        all_to_all(bins, devs)
        psum(bins, devs)
    summary = exchange_summary(recs)
    assert [r["op"] for r in summary] == ["all_to_all", "psum"]
    nbytes = 4 * 4 * 100 * 8
    assert summary[0]["read_bytes"] == summary[0]["write_bytes"] == nbytes
    assert summary[1]["read_bytes"] == nbytes and summary[1]["write_bytes"] == 4 * 100 * 8
    assert all(r["crossed_bytes"] == 0 and r["ms"] >= 0 for r in summary)
    assert [s.name for s in recs] == ["strawboat.exchange.all_to_all", "strawboat.exchange.psum"]


# ---------------------------------------------------------------------------
# the program's spans


def test_resident_query_spans(rt):
    with obs.recording() as rec:
        tpch.q6(rt)
        tpch.q1(rt)
    six, one = [r for r in rec.roots if r.name == "strawboat.query"]
    assert six.attrs == {"path": "filter_sum"} and one.attrs == {"path": "fused"}
    assert [c.name.rsplit(".", 1)[1] for c in six.children] == [
        "plan", "decode", "filter", "aggregate"]
    assert [c.name.rsplit(".", 1)[1] for c in one.children] == [
        "plan", "decode", "filter", "aggregate", "fetch", "finish"]
    assert all(c.device_ms is None for r in (six, one) for c in r.children)  # the CPU: no events


def test_program_spans_nest_in_a_cpu_profiler_trace(tmp_path, cols, rt):
    path = str(tmp_path / "l.str")

    def run():
        tpch.q6(rt)
        tpch.q1(rt)
        tpch.write_lineitem(path, cols, max_page_size=4096, zone_maps=True)
        scan_file(path, "cpu")

    ranges = _trace(tmp_path, run)
    names = {r[0] for r in ranges}
    for phase in ("plan", "decode", "filter", "aggregate", "fetch", "finish"):
        assert _inside(ranges, f"strawboat.query.{phase}", "strawboat.query"), phase
    for phase in ("prepare", "io"):
        assert _inside(ranges, f"strawboat.write.{phase}", "strawboat.write"), phase
    for phase in ("open", "plan", "parse", "decompress", "copy", "decode"):
        assert _inside(ranges, f"strawboat.scan.{phase}", "strawboat.scan"), phase
    assert {n.split(".")[0] for n in names} == {"strawboat"}
    # the pool's pages are in the recorder, under the write's root
    write = obs.last_roots(1, "strawboat.write")[0]
    pages = [s for s in write.children if s.name == "strawboat.write.page"]
    assert len(pages) == _total(write, "write.pages") == 10 * -(-ROWS // 4096)
    assert all(any(c.name == "strawboat.write.encode" for c in p.walk()) for p in pages)


def test_writer_spans_and_trials_under_the_chooser(tmp_path, cols):
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.write import write_file

    data = {k: cols[k] for k in tpch.INT_COLUMNS}
    opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                        max_page_size=4096, sample_seed=3)
    with obs.recording() as rec:
        write_file(str(tmp_path / "a.str"), data, options=opts)
    (root,) = rec.roots
    names = [s.name for s in root.walk()]
    pages = names.count("strawboat.write.page")
    assert pages == rec.counters["write.pages"] == len(data) * -(-ROWS // 4096)
    assert names.count("strawboat.write.stats") >= pages
    assert names.count("strawboat.write.choose") >= pages
    assert rec.counters["write.trials"] > 0 and _total(root, "write.trials") == rec.counters[
        "write.trials"]


def test_scan_counters(tmp_path, cols):
    path = str(tmp_path / "l.str")
    tpch.write_lineitem(path, cols, columns=tpch.INT_COLUMNS, max_page_size=4096, zone_maps=True)
    with obs.recording() as rec:
        scan_file(path, "cpu", predicates=tpch.q6_pruning_predicates())
    (root,) = rec.roots
    planned, kept = rec.counters["scan.pages_planned"], rec.counters["scan.pages_kept"]
    assert planned == len(tpch.INT_COLUMNS) * -(-ROWS // 4096) and 0 < kept <= planned
    assert _total(root, "scan.pages_kept") == kept
    assert "scan.h2d_bytes" not in rec.counters  # nothing crosses to a CPU device


def test_answers_are_the_same_with_recording_on_and_off(tmp_path, cols, rt):
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.write import write_file

    opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                        max_page_size=4096, sample_seed=3, zone_maps=True)
    data = {k: cols[k] for k in tpch.INT_COLUMNS}

    def answers(tag):
        path = str(tmp_path / f"{tag}.str")
        write_file(path, data, options=opts)
        table = scan_file(path, "cpu")
        q1 = tpch.q1(rt)
        return (int(tpch.q6(rt)), {k: np.asarray(v).tobytes() for k, v in q1.items()},
                open(path, "rb").read(), {k: host_values(c).tobytes() for k, c in
                                          table.columns.items()})

    off = answers("off")
    with obs.recording() as rec:
        on = answers("on")
    assert rec.roots and on == off


def test_the_cost_script_runs_on_the_cpu(tmp_path):
    import runpy

    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "scripts", "torch_obs_cost.py")
    main = runpy.run_path(script)["main"]
    assert main(["--device", "cpu", "--rows", "20000", "--reps", "2", "--rounds", "1",
                 "--out", str(tmp_path)]) == 0
    with open(tmp_path / "obs_cost.json") as f:
        got = json.load(f)
    assert got["device"] == "cpu" and got["order"] == ["off", "on", "on", "off"]
    assert got["q6_off_host_ms"] > 0 and got["q1_on_host_ms"] > 0
    assert got["q6_off_device_ms"] is None and got["q1_decode_device_ms"] is None  # no card


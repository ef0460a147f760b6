"""The readers of the program's own spans and counters on made-up runs:
a synthetic ``ctx`` and a stand-in for the program's recorder."""

from types import SimpleNamespace

import pytest

from benchmark.lib import manifest as mf
from benchmark.lib import program_spans

NEW = ("program_idle_share", "decode_device_ms", "aggregate_device_ms", "write_choose_share",
       "write_trials_per_page")


def _ctx(**kw):
    base = dict(cell="c", setup_s=12.5, window_s=10.0, done=[], trace=None,
                stretch_ops=0, facts={})
    base.update(kw)
    return SimpleNamespace(**base)


def read(name, ctx):
    return mf.plugin("metrics", name).read(ctx)


class FakeSpan:
    def __init__(self, name, start_ns=0, end_ns=0, device_ms=None, children=()):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.device_ms, self.children = device_ms, list(children)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class FakeRecorder:
    def __init__(self, roots=(), counters=None):
        self.roots, self.counters = list(roots), dict(counters or {})

    def last_roots(self, n=None, name=None):
        roots = [r for r in self.roots if name is None or r.name == name]
        return roots[max(len(roots) - n, 0):] if n else []

    def counter(self, name):
        return self.counters.get(name, 0)


@pytest.fixture
def recorder(monkeypatch):
    def install(rec):
        monkeypatch.setattr(program_spans, "recorder", lambda: rec)
    return install


def test_readers_with_nothing_to_read_give_nothing(recorder):
    recorder(None)  # a program without the recorder, as the parent of its PR
    t = SimpleNamespace(window_s=1.0, gaps=[(0.1, 0.2)], host=[(0.0, 1.0, "aten::add")])
    for name in NEW:
        assert read(name, _ctx()) is None, name
        assert read(name, _ctx(trace=t, stretch_ops=4)) is None, name
    recorder(FakeRecorder())
    for name in NEW:
        assert read(name, _ctx(trace=t, stretch_ops=4)) is None, name


def test_program_idle_share_counts_gaps_inside_query_ranges():
    # a 1 s stretch; idle gaps of 0.1 s each; queries cover [0.0, 0.35] and
    # [0.5, 0.95], one of them split into overlapping child ranges
    t = SimpleNamespace(
        window_s=1.0,
        gaps=[(0.0, 0.1), (0.3, 0.4), (0.45, 0.55), (0.9, 1.0)],
        host=[(0.0, 0.35, "strawboat.query"), (0.5, 0.95, "strawboat.query"),
              (0.5, 0.6, "strawboat.query.decode"), (0.3, 0.6, "aten::item")])
    # inside: 0.1 + 0.05 + 0.05 + 0.05 = 0.25 of the 0.4 s idle
    assert read("program_idle_share", _ctx(trace=t)) == pytest.approx(25.0)
    t.host.append((0.34, 0.52, "strawboat.query"))  # overlapping ranges count once
    assert read("program_idle_share", _ctx(trace=t)) == pytest.approx(35.0)


def test_phase_device_ms_is_a_mean_over_the_stretchs_last_queries(recorder):
    def query(decode, aggregate):
        return FakeSpan("strawboat.query", children=[
            FakeSpan("strawboat.query.plan"),
            FakeSpan("strawboat.query.decode", device_ms=decode),
            FakeSpan("strawboat.query.aggregate", device_ms=aggregate)])

    early = [query(99.0, 99.0)]  # a query before the stretch: left out
    recorder(FakeRecorder(early + [query(1.0, 3.0), query(2.0, 5.0)]
                          + [FakeSpan("strawboat.write")]))
    ctx = _ctx(stretch_ops=2)
    assert read("decode_device_ms", ctx) == pytest.approx(1.5)
    assert read("aggregate_device_ms", ctx) == pytest.approx(4.0)
    recorder(FakeRecorder([query(None, None)]))  # the CPU: spans without events
    assert read("decode_device_ms", _ctx(stretch_ops=1)) is None


def test_write_choose_share_over_every_pages_time(recorder):
    def page(start, stats, choose, encode):
        kids = [FakeSpan("strawboat.write.stats", start, start + stats),
                FakeSpan("strawboat.write.choose", start + stats, start + stats + choose),
                FakeSpan("strawboat.write.encode", start + stats + choose,
                         start + stats + choose + encode,
                         children=[FakeSpan("strawboat.write.stats", 0, 5),
                                   FakeSpan("strawboat.write.choose", 5, 10)])]
        return FakeSpan("strawboat.write.page", start, start + stats + choose + encode + 10,
                        children=kids)

    # two pages in parallel threads: (20 + 30 + 10) and (10 + 10 + 10) of 100 and 70
    w = FakeSpan("strawboat.write", 0, 200,
                 children=[FakeSpan("strawboat.write.prepare", 0, 50), page(50, 20, 30, 40),
                           page(50, 10, 10, 40)])
    early = FakeSpan("strawboat.write", 0, 10, children=[page(0, 1, 1, 1)])
    recorder(FakeRecorder([early, w]))
    assert read("write_choose_share", _ctx(stretch_ops=1)) == pytest.approx(100 * 90 / 170)


def test_write_trials_per_page(recorder):
    recorder(FakeRecorder(counters={"write.trials": 30, "write.pages": 12}))
    assert read("write_trials_per_page", _ctx()) == 2.5
    recorder(FakeRecorder(counters={"write.trials": 0, "write.pages": 0}))
    assert read("write_trials_per_page", _ctx()) is None


def test_the_program_has_the_recorder_the_readers_read():
    obs = program_spans.recorder()
    assert obs is not None
    with obs.recording():
        with obs.span(program_spans.QUERY):
            pass
    assert program_spans.last_roots(program_spans.QUERY, 1)[0].name == program_spans.QUERY
    assert program_spans.last_roots(program_spans.QUERY, 0) == []
